"""The moe family's tensor-parallel train step (`repro_torch.train.loop`'s
`make_sharded_train_step` for dbrx-132b and deepseek-v3-671b) and the
MoE's routing on the global batch's row grid in every sharded step, on
the CPU against the reference.

The reference's `moe_block` routes the whole batch's tokens as rows of
the largest divisor of their count that is at most 32; a jitted SPMD step
computes that whatever the mesh. The port's sharded steps route each
data rank's tokens on that same grid (`repro_torch.models.moe`'s
`routing_grid`), and the train step forms the global batch's auxiliary
loss. The gloo ranks (4 as (data 2, model 2), 8 as (data 2, model 4))
run `torch_dist_workers.moe_train_worker`, spawned once a group, while
this process computes the reference's steps. The census runs rank 0's
step at full width on meta tensors over a fake (16, 16) group
(`torch_dist_workers.full_census`). Tolerances are
tests/test_torch_distributed.py's.
"""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import moe as ref_moe
from repro.train import loop as ref_loop
from repro.train.optim import adamw_init as ref_adamw_init
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import _n_rows, routing_grid
from repro_torch.train import loop, optim

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# a router top-k gap below which another float32 summation order could
# flip the choice: the sharded step's probabilities differ from the
# one-process step's by ~1e-7
TIE_GAP = 1e-6
PREFILL_TOL = dict(rtol=1e-5, atol=1e-5)     # the prefill tests'
SHAPES = [(2, 2), (2, 4)]
SHAPE_IDS = ["2x2", "2x4"]
CASES = sorted({(arch, variant)
                for arch, variant, *_ in workers.MOE_TRAIN_RUNS})
RUN_IDS = [f"{arch}-{variant}-{length}" + (f"-cf{factor}" if factor else "")
           for arch, variant, length, factor in workers.MOE_TRAIN_RUNS]


def _agree(got, want, tight, loose, share, name):
    err = np.abs(got - want)
    assert err.max() <= loose, (name, float(err.max()), loose)
    assert np.mean(err > tight) <= share, (name, float(np.mean(err > tight)))


def _ref_config(arch: str, variant: str, factor=None):
    cfg = ref_config(arch, "smoke").replace(
        dtype=jnp.float32, **workers.moe_variant(arch, variant))
    return cfg if factor is None else cfg.replace(capacity_factor=factor)


def _spawn(out, world: int, shape: tuple) -> threading.Thread:
    """``moe_train_worker`` on ``world`` gloo ranks, in a thread, so that
    this process computes the reference meanwhile."""
    run = out / f"mesh{world}"
    run.mkdir()
    for weights in out.glob("weights_moe_*.pt"):
        (run / weights.name).write_bytes(weights.read_bytes())
    thread = threading.Thread(target=workers.spawn, args=(
        workers.moe_train_worker, world, str(run), shape))
    thread.start()
    return thread


@contextlib.contextmanager
def _gaps(into: list):
    """Each `moe.top_k` call's smallest gap between a row's k-th and
    (k+1)-th probability appended to ``into`` while the block runs."""
    inner = moe_mod.top_k

    def top_k(probs, k):
        vals, _ = torch.sort(probs, dim=-1, descending=True, stable=True)
        into.append(float((vals[..., k - 1] - vals[..., k]).min()))
        return inner(probs, k)

    moe_mod.top_k = top_k
    try:
        yield
    finally:
        moe_mod.top_k = inner


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """The reference's models of CASES (float32, weights drawn from
    TRAIN's seed, carried across by `interop.model_params`), the gloo
    ranks' results on 4 and 8 ranks (keyed by world) and, from the same
    weights and batches, by MOE_TRAIN_RUNS run: the reference's
    ("reference": its jitted `make_train_step`'s metrics and state after
    TRAIN's steps, and the first batch's gradients before clipping,
    recovered from the first step's first moment, mu = (1 - b1) x the
    clipped gradient, and the clip's scale min(1, 1 / grad_norm)) and
    the port's one-process `make_train_step`'s ("one process"), and the
    smallest router top-k gap of each run's one-process steps."""
    out = tmp_path_factory.mktemp("moe_train")
    refs = {}
    for arch, variant in CASES:
        rm = ref_build(_ref_config(arch, variant))
        params = rm.init(jax.random.PRNGKey(workers.TRAIN["seed"]))
        torch.save(interop.model_params(
            jax.tree.map(np.asarray, params),
            workers.moe_train_config(arch, variant), "cpu"),
            workers.moe_weights(str(out), arch, variant))
        refs[arch, variant] = params
    threads = [_spawn(out, 4, (2, 2)), _spawn(out, 8, (2, 4))]
    try:
        t = workers.TRAIN
        kw = dict(base_lr=t["base_lr"], warmup=t["warmup"],
                  total_steps=t["total_steps"])
        f32 = dict(dtype=torch.float32)
        wants, gaps = {}, {}
        for arch, variant, length, factor in workers.MOE_TRAIN_RUNS:
            rm = ref_build(_ref_config(arch, variant, factor))
            params = refs[arch, variant]
            rstep = jax.jit(ref_loop.make_train_step(rm, **kw))
            cfg = workers.moe_train_config(arch, variant, factor)
            batches = workers.moe_train_batches(cfg, length)
            rstate = ref_loop.TrainState(params=params,
                                         opt=ref_adamw_init(params), ef=None)
            model = Model(cfg, "cpu")
            state = interop.train_state(jax.tree.map(np.asarray, rstate),
                                        model)
            total, _ = model.loss(batches[0])
            one = {"grads": dict(zip(state.params, torch.autograd.grad(
                total, list(state.params.values())))), "metrics": []}
            ref = {"metrics": []}
            step = loop.make_train_step(model, **kw)
            gaps[arch, variant, length, factor] = []
            for i, batch in enumerate(batches):
                rstate, rmet = rstep(rstate, {k: jnp.asarray(v.numpy())
                                              for k, v in batch.items()})
                with _gaps(gaps[arch, variant, length, factor]):
                    state, met = step(state, batch)
                ref["metrics"].append({k: float(v) for k, v in rmet.items()})
                one["metrics"].append({k: float(v) for k, v in met.items()})
                if i == 0:
                    clip = min(1.0, 1.0 / ref["metrics"][0]["grad_norm"])
                    ref["grads"] = {n: g / ((1 - 0.9) * clip)
                                    for n, g in interop.model_params(
                        jax.tree.map(np.asarray, rstate.opt.mu), cfg, "cpu",
                        **f32).items()}
            rs = jax.tree.map(np.asarray, rstate)
            ref.update(params=interop.model_params(rs.params, cfg, "cpu"),
                       mu=interop.model_params(rs.opt.mu, cfg, "cpu", **f32),
                       nu=interop.model_params(rs.opt.nu, cfg, "cpu", **f32))
            one.update(params={n: p.detach() for n, p in state.params.items()},
                       mu=state.opt.mu, nu=state.opt.nu)
            wants[arch, variant, length, factor] = {"reference": ref,
                                                 "one process": one}
    finally:
        for thread in threads:
            thread.join()
    ranks = {world: torch.load(out / f"mesh{world}" / f"moe_train{world}.pt",
                               weights_only=False) for world in (4, 8)}
    return refs, ranks, wants, gaps


# --------------------------------------- the routing fault and its repair

def _fault_inputs(refs):
    """MOE_FAULT's reference config, its first MoE layer's weights and the
    unit case's input (`torch_dist_workers.moe_input`)."""
    f = workers.MOE_FAULT
    cfg = _ref_config(f["arch"], "smoke", f["capacity_factor"])
    layer = jax.tree.map(lambda a: a[0],
                         refs[f["arch"], "smoke"]["moe_layers"]["moe"])
    x = workers.moe_input(workers.moe_train_config(f["arch"], "smoke"))
    return cfg, layer, jnp.asarray(x.numpy())


def test_the_fault_case_routes_otherwise_on_each_half(moe_runs):
    """The case bites: the reference's `moe_block` over MOE_FAULT's whole
    batch (4 rows x 128 tokens: 32 routing rows of 16) differs from the
    concatenation of its halves' (2 rows each: 32 rows of 8, what each of
    2 data ranks would route on its own tokens), as the capacity of a
    16-token row drops other choices than an 8-token row's; and the
    halves' mean auxiliary loss is not the whole batch's."""
    cfg, layer, x = _fault_inputs(moe_runs[0])
    whole, aux = ref_moe.moe_block(layer, x, cfg)
    halves = [ref_moe.moe_block(layer, x[i:i + 2], cfg) for i in (0, 2)]
    split = np.concatenate([np.asarray(h[0]) for h in halves])
    gap = np.abs(np.asarray(whole) - split).max(axis=-1)
    assert (gap > 1e-3).sum() >= 16 and gap.max() > 0.1, gap.max()
    mean_aux = np.mean([float(h[1]) for h in halves])
    assert abs(mean_aux - float(aux)) > 1e-5 * abs(float(aux))


def test_sharded_moe_prefill_step_routes_on_the_global_grid(moe_runs):
    """MOE_FAULT's sharded prefill step (dbrx smoke, float32, capacity
    factor 0.5, 4 rows x 128 tokens, on 4 gloo ranks as (data 2, model
    2)) equals the reference's jitted `make_prefill_step` within the
    prefill tests' 1e-5: each data rank routes its 2 rows' tokens as 16
    of the global grid's 32 rows of 16 tokens, not as 32 rows of 8 of
    its own, which drop other choices."""
    refs, ranks, *_ = moe_runs
    f = workers.MOE_FAULT
    rm = ref_build(_ref_config(f["arch"], "smoke", f["capacity_factor"]))
    batch = workers.prefill_batch(
        workers.moe_train_config(f["arch"], "smoke"), f["rows"], f["length"])
    want = np.asarray(jax.jit(ref_loop.make_prefill_step(rm))(
        refs[f["arch"], "smoke"], {"tokens": jnp.asarray(
            batch["tokens"].numpy())}))
    got = ranks[4]["prefill"].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **PREFILL_TOL)


@pytest.mark.parametrize("split", workers.MOE_SPLITS)
def test_moe_block_under_a_data_split_equals_the_whole_batch(moe_runs, split):
    """`moe_block` alone on MOE_FAULT's input, its 4 rows split over 2 or
    4 data ranks ((2, 2) and (4, 1) meshes of the same 4 gloo ranks),
    expert parallel under the train step's context: the outputs,
    gathered over 'data', equal the reference's over the whole batch
    within 1e-5, and the auxiliary loss, summed over 'data' before it is
    formed, the whole batch's within 1e-5 relative."""
    cfg, layer, x = _fault_inputs(moe_runs[0])
    want, want_aux = ref_moe.moe_block(layer, x, cfg)
    got = moe_runs[1][4]["unit", split]
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want),
                               **PREFILL_TOL)
    np.testing.assert_allclose(float(got["aux"]), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("tokens,n_data", [(128, 2), (512, 4), (8, 16),
                                           (4, 32), (2, 16), (63, 2)])
def test_routing_grid_is_the_global_batchs(tokens, n_data):
    """A data rank's routing rows are its whole block of the global grid:
    the reference's rows over every data rank's tokens (`_n_rows`), one
    n_data-th of them each, of the same length. At the production
    meshes' 16 and 32 data ranks decode_32k's 8 and 4 tokens a rank make
    2 rows of 4 and 1 of 4; 63 tokens on 2 ranks (126) make 1 row of 63
    each, where the rank's own grid would be 63 rows of 1."""
    rows, length = routing_grid(tokens, n_data)
    total = _n_rows(tokens * n_data, 32)
    assert rows * n_data == total and rows * length == tokens
    assert length == tokens * n_data // total


def test_routing_grid_refuses_a_row_across_data_ranks():
    """7 tokens on each of 3 data ranks: 21 tokens route as one row, which
    3 data ranks cannot hold in whole rows: ValueError, with the
    numbers, before any collective (every step calls it first)."""
    with pytest.raises(ValueError, match="21 tokens route as 1 rows of 21, "
                                         "which 3 data ranks do not divide"):
        routing_grid(7, 3)


# ------------------------------------------ the tensor-parallel train step

@pytest.mark.parametrize("run", workers.MOE_TRAIN_RUNS, ids=RUN_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_tensor_parallel_moe_train_step_equals_reference_and_one_process(
        moe_runs, shape, run):
    """The tensor-parallel `make_sharded_train_step` of the moe family
    (MOE_TRAIN_RUNS: dbrx and deepseek smokes and widened by MOE_WIDE,
    FSDP storage, float32, 4 rows of 72 tokens; the dbrx smoke also of
    129 with capacity factor 0.5, so that choices drop, and with 6
    experts, whole on 4 'model' ranks) on 4 gloo ranks
    as (data 2, model 2) and on 8 as (data 2, model 4), against the
    reference's jitted `make_train_step` and the port's one-process step
    on the same weights and batches: every leaf's gradient of the first
    batch before clipping within GRAD_TOL of the leaf's largest
    magnitude; each of TRAIN's steps' loss, ce, aux, mtp (deepseek) and
    grad_norm within 1e-5 relative; the parameters and moments after
    them within tests/test_torch_distributed.py's bounds, a parameter's
    share of entries past the tight bound plus the share that rounding
    alone moves there: the two one-process steps', the reference's and
    the port's, against each other (AdamW's m / sqrt(v) magnifies a
    rounding where m cancels; deepseek's widened router, 128 experts,
    holds 0.25 % so, every other leaf of every run none). The step never
    reads the model's parameters; the FSDP storage splits the fan-in over
    'data', and the experts lie over 'model' where it divides them."""
    arch, variant, length, factor = run
    got = moe_runs[1][4 if shape == (2, 2) else 8]["train"][run]
    assert got["reads_model_params"] is False
    placed = got["param_placements"]
    assert placed["embed"] == ["S(1)", "S(0)"]
    whole = variant == "odd" and shape == (2, 4)
    assert placed["moe_layers.0.moe.experts.w_gate"] == (
        ["S(1)", "R"] if whole else ["S(1)", "S(0)"])
    t = workers.TRAIN
    lr_fn = optim.cosine_schedule(t["base_lr"], t["warmup"],
                                  t["total_steps"])
    lr_sum = sum(float(lr_fn(s)) for s in range(t["steps"]))
    keys = ("loss", "ce", "aux", "grad_norm") + (
        ("mtp",) if arch == "deepseek-v3-671b" else ())
    for which, want in moe_runs[2][run].items():
        assert sorted(got["grads"]) == sorted(want["grads"])
        for name, g in want["grads"].items():
            scale = max(float(g.abs().max()), 1e-12)
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(),
                                       rtol=0, atol=GRAD_TOL * scale,
                                       err_msg=f"{which} {name}")
        assert len(got["metrics"]) == len(want["metrics"]) == t["steps"]
        for i, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
            for k in keys:
                np.testing.assert_allclose(gm[k], wm[k], rtol=LOSS_RTOL,
                                           err_msg=f"{which} {k} step {i}")
        for name, w in want["params"].items():
            w = w.numpy()
            tight = 1e-6 + 1e-6 * np.abs(w)
            # the share that rounding alone moves: the two one-process
            # steps' (the reference's and the port's) against each other
            ref = moe_runs[2][run]["reference"]["params"][name].numpy()
            one = moe_runs[2][run]["one process"]["params"][name].numpy()
            share = 1e-3 + np.mean(np.abs(one - ref)
                                   > 1e-6 + 1e-6 * np.abs(ref))
            _agree(got["params"][name].numpy(), w, tight, 0.02 * lr_sum,
                   share, f"{which} {name}")
        for tree in ("mu", "nu"):
            for name, w in want[tree].items():
                scale = max(float(w.abs().max()), 1e-12)
                _agree(got[tree][name].numpy(), w.numpy(), GRAD_TOL * scale,
                       GRAD_TOL * scale, 1e-3, f"{which} {tree}.{name}")


@pytest.mark.parametrize("run", workers.MOE_TRAIN_RUNS, ids=RUN_IDS)
def test_moe_train_batches_hold_no_router_tie(moe_runs, run):
    """Along each run's one-process steps every router's k-th choice leads
    the next by at least TIE_GAP (`moe_train_batches`), so the sharded
    step, whose probabilities differ by float32 rounding, chooses alike."""
    gaps = moe_runs[3][run]
    assert len(gaps) == workers.TRAIN["steps"] * 2 and min(gaps) >= TIE_GAP


def test_the_dropping_case_drops_choices(moe_runs):
    """The dbrx smoke's run at capacity factor 0.5 drops choices on the
    global grid (129 tokens: 4 rows of 128 positions, 32 routing rows of
    16 tokens, a capacity of 8 slots an expert for 32 choices over 4
    experts): the one-process model's first MoE layer, on the first
    batch, overflows some expert of some row."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import embed, rms_norm
    from repro_torch.models.moe import top_k
    arch, variant, length, factor = workers.MOE_TRAIN_RUNS[1]
    cfg = workers.moe_train_config(arch, variant, factor)
    model = Model(cfg, "cpu")
    model.load_state_dict(interop.model_params(
        jax.tree.map(np.asarray, moe_runs[0][arch, variant]), cfg, "cpu"))
    tokens = workers.moe_train_batches(cfg, length)[0]["tokens"][:, :-1]
    block = model.moe_layers[0]
    with torch.no_grad():
        x = embed(model.embed, tokens)
        x = x + attn.attention_block(block.attn, rms_norm(x, block.ln1), cfg)
        h = rms_norm(x, block.ln2)
    r, tl = routing_grid(h.shape[0] * h.shape[1])
    assert (r, tl) == (32, 16)
    _, top_i = top_k(torch.softmax(h.reshape(r, tl, -1) @ block.moe.router,
                                   dim=-1), cfg.top_k)
    counts = torch.stack([torch.bincount(row, minlength=cfg.n_experts)
                          for row in top_i.reshape(r, -1)])
    cap = max(int(tl * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 4)
    cap = (cap + 7) // 8 * 8
    assert cap == 8 and (counts > cap).any()


@pytest.mark.parametrize("arch", list(workers.MOE_WIDE))
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_tensor_parallel_moe_train_step_runs_on_a_meta_model(moe_runs, shape,
                                                             arch):
    """A step of the dbrx and deepseek smokes whose model lives on the
    meta device (the step reads only the state's shards) equals, bit for
    bit, the same step of the model on the CPU: metrics, parameters and
    moments; neither reads the model's parameters."""
    got = moe_runs[1][4 if shape == (2, 2) else 8]["train"]["meta", arch]
    (meta_met, meta, meta_reads), (cpu_met, cpu, cpu_reads) = got
    assert meta_reads is False and cpu_reads is False
    assert meta_met == cpu_met
    for tree in ("params", "mu", "nu"):
        assert sorted(meta[tree]) == sorted(cpu[tree])
        for name, want in cpu[tree].items():
            assert torch.equal(meta[tree][name], want), (tree, name)


# ------------------------------------------------------------- the census

# the full configs at full width cut in depth: dbrx 2 MoE layers,
# deepseek 1 dense + 1 MLA/MoE and its MTP depth; 32 rows of 4096
# positions (2 a data rank), FSDP storage, meta tensors, bf16
MOE_TRAIN_CENSUS = {"dbrx-132b": dict(n_layers=2),
                    "deepseek-v3-671b": dict(n_layers=2, n_dense_layers=1)}
CENSUS_LEN = 4096
# the whole parameters the prefill rule gathers where 'model' splits them:
# the norm scales, the router, MLA's latent projections and the MTP
# depth's proj (gathering the merged input of every position instead
# would move 2 x 4095 x 14336 bf16 a row, 9x the weight at 16 rows)
ALLOWED = ("ln1", "ln2", "ln", "q_norm", "k_norm", "kv_norm", "final_norm",
           "router", "w_dq", "w_dkv", "proj")


@pytest.fixture(scope="module")
def moe_census():
    """`full_census`'s train record of each MOE_TRAIN_CENSUS cell, the
    subprocesses at once."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(MOE_TRAIN_CENSUS)) as pool:
        got = pool.map(lambda arch: workers.full_census(
            arch, MOE_TRAIN_CENSUS[arch], 32, CENSUS_LEN, train=True),
            MOE_TRAIN_CENSUS)
        return dict(zip(MOE_TRAIN_CENSUS, got))


@pytest.mark.parametrize("arch", list(MOE_TRAIN_CENSUS))
def test_tensor_parallel_moe_train_step_gathers_no_weight_but_the_small_ones(
        moe_census, arch):
    """The census of the moe family's tensor-parallel train step on a fake
    (16, 16) group of 256 ranks (no data moves): dbrx-132b and
    deepseek-v3-671b at full width cut in depth (MOE_TRAIN_CENSUS), FSDP
    storage, 2 rows of 4096 positions a data rank. The only parameters
    gathered whole are ALLOWED's (the norm scales, deepseek's router and
    MLA's ``w_dq``/``w_dkv``, and the MTP depth's ``proj``, 205 MB in
    bf16, the choice over gathering its merged input); no expert weight
    is gathered over 'model' (the rank holds E / 16 experts, gathered
    over 'data' alone, its FSDP storage); every split matrix's gradient
    leaves as one reduce-scatter over 'data' of the rank's 'model' shard;
    each MoE layer's auxiliary loss sums the router probabilities' means
    over 'data' (E float32, and its adjoint in the backward) and the
    choices' counts (E int64, no adjoint). The step never reads the
    model's parameters."""
    got = moe_census[arch]
    cfg = get_config(arch, "full").replace(**MOE_TRAIN_CENSUS[arch])
    assert got["reads_model_params"] is False
    assert got["experts_local"][0] == cfg.n_experts // 16
    moved = {kind: [b for k, b in got["collectives"] if k == kind]
             for kind in ("all-gather", "reduce-scatter", "all-reduce",
                          "all-to-all", "collective-permute")}
    assert not moved["collective-permute"]
    full = {name: b[0] for name, b in got["param_bytes"].items()}
    gathered = set(moved["all-gather"])
    whole = {name for name in got["model_split"] if full[name] in gathered}
    assert all(name.rsplit(".", 1)[-1] in ALLOWED for name in whole), whole
    if cfg.use_mla:
        assert {"mtp.proj", "moe_layers.0.attn.w_dq",
                "moe_layers.0.attn.w_dkv"} <= whole
    experts = {n for n in full if ".experts." in n}
    assert not {full[n] for n in experts} & gathered
    assert {full[n] // 16 for n in experts} <= gathered   # over 'data' only
    scattered = set(moved["reduce-scatter"])
    for name in got["model_split"]:
        if name.rsplit(".", 1)[-1] not in ALLOWED:      # 1/16 of its shard
            assert full[name] // 256 in scattered, name
    n_moe = cfg.n_layers - cfg.n_dense_layers
    e = cfg.n_experts
    assert moved["all-reduce"].count(e * 8) == n_moe            # the counts
    assert moved["all-reduce"].count(e * 4) == 2 * n_moe        # the means


def test_dbrx_train_flops_are_the_closed_form(moe_census):
    """dbrx-132b's 2-layer train_4k census: FLOPs exactly three times the
    forward's products (the backward's two products a forward one) on
    the rank's shard of the work, 2 rows of 4096 positions (t = 8192
    tokens): its 3 q heads of wq and rows of wo, the whole KV head they
    read (8 KV heads on 16 ranks: 128 columns of wk and wv, not 64), the
    attention of its q heads over every position, the router whole over
    every position of its rows, its one expert's products over its
    routing rows of the global grid (2 of 32, each of 4096 tokens; a
    capacity of 4096 x 4 / 16 x 1.25 = 1280 slots: 3 x 2 x 2560 x d x
    d_ff), and its 6272 vocabulary rows. Over the one-process step / 16
    by the KV heads and the router alone: 0.98 %."""
    got = moe_census["dbrx-132b"]
    cfg = get_config("dbrx-132b", "full")
    d, hq, hkv, dh, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.d_head, cfg.padded_vocab)
    e, k, ff = cfg.n_experts, cfg.top_k, cfg.d_ff_expert
    n, rows, s = 16, 2, CENSUS_LEN
    t = rows * s
    r, tl = routing_grid(t, n)
    cap = max(int(tl * k / e * cfg.capacity_factor), 4)
    cap = (cap + 7) // 8 * 8
    assert (r, tl, cap) == (2, 4096, 1280)
    layer = (2 * t * d * hq * dh // n + 2 * 2 * t * d * max(hkv // n, 1) * dh
             + 4 * rows * s * s * (hq // n) * dh + 2 * t * hq * dh // n * d
             + 2 * t * d * e + 3 * 2 * (e // n) * r * cap * d * ff)
    want = 3 * (2 * layer + 2 * t * d * v // n)
    assert got["flops"] == want
    naive = 3 * (2 * (2 * t * d * (2 * hq * dh + 2 * hkv * dh + e)
                      + 4 * rows * s * s * hq * dh
                      + 3 * 2 * e * (n * r) * cap * d * ff // n)
                 + 2 * t * d * v) // n
    assert 1.0097 < want / naive < 1.0098, want / naive
