"""The port's production-mesh dry run (`repro_torch.launch.dryrun`) on the
CPU: rank 0's step of a cell on meta tensors over a fake process group
of 256 or 512 ranks.

Each cell runs in a subprocess through the CLI at ``--layers 2`` (as
tests/test_distributed.py runs its fabricated-device bodies), a few at a
time: one ``decode_32k`` single-mesh cell per family, qwen3-0.6b's
``train_4k`` and ``prefill_32k``, dbrx-132b's ``decode_32k`` on the
multi-pod mesh and mamba2-2.7b's and recurrentgemma-2b's ``long_500k``.
Every record must be
``ok`` with the keys the module docstring lists, and its argument bytes
exactly `launch.specs`' sum; qwen3-0.6b's decode FLOPs a closed form,
its train step's collectives those its layouts imply; the census is
exact on a hand-built DTensor program; the router reads a record the
CLI wrote; `decode_attention` on meta returns the kernel's output shape
and counts its cost, which is the call's own FLOPs and bytes and the
one chip_smoke.py's bound reads.
"""

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.distributed import sharding
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_cost)
from repro_torch.launch import specs
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.models import Model
from repro_torch.models.moe import routing_grid
from repro_torch.serve import router

ROOT = Path(__file__).resolve().parent.parent
LAYERS = 2
# (arch, shape, mesh) and the record's decode_attention calls at 2 layers
CELLS = {
    ("qwen3-0.6b", "decode_32k", "single"): 2,
    ("recurrentgemma-2b", "decode_32k", "single"): 1,   # 3 layers, 1 attn
    ("whisper-base", "decode_32k", "single"): 4,        # self + cross
    ("internvl2-76b", "decode_32k", "single"): 2,
    ("deepseek-v3-671b", "decode_32k", "single"): 1,    # MLA launches none
    ("mamba2-2.7b", "decode_32k", "single"): 0,
    ("qwen3-0.6b", "train_4k", "single"): 0,
    ("qwen3-0.6b", "prefill_32k", "single"): 0,
    ("dbrx-132b", "decode_32k", "multi"): 2,
    ("mamba2-2.7b", "long_500k", "single"): 0,
    ("recurrentgemma-2b", "long_500k", "single"): 1,    # the ring over 'data'
}
KEYS = {"ok", "arch", "shape", "mesh", "devices", "n_layers_override",
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "device_bytes_total", "compute_peak_bytes",
        "compute_bytes", "hlo_flops", "hlo_bytes",
        "collectives", "trace_s", "total_s", "decode_attention_calls",
        "rank_rows", "reads_model_params"}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [env.get("PYTHONPATH")])])
    return env


def _run_cell(out: Path, cell) -> dict:
    arch, shape, mesh = cell
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--layers", str(LAYERS),
         "--out", str(out)],
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=300)
    assert proc.returncode == 0, (cell, proc.stdout[-2000:],
                                  proc.stderr[-3000:])
    return json.loads((out / f"{arch}__{shape}__{mesh}__L{LAYERS}.json"
                       ).read_text())


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda c: _run_cell(out, c), CELLS))
    return dict(zip(CELLS, got)), out


def _mesh(kind: str):
    return make_production_mesh(multi_pod=kind == "multi")


@pytest.mark.parametrize("cell", list(CELLS), ids=["-".join(c) for c in CELLS])
def test_record_is_ok_with_its_keys_and_argument_bytes(records, cell):
    rec = records[0][cell]
    arch, shape, mesh = cell
    assert rec["ok"] is True and set(rec) == KEYS
    assert (rec["arch"], rec["shape"], rec["mesh"]) == cell
    assert rec["devices"] == (512 if mesh == "multi" else 256)
    assert rec["n_layers_override"] == LAYERS
    _, args = specs.cell_lowerable(arch, shape, _mesh(mesh), LAYERS)
    sharding.clear_mesh()
    sharding.set_fsdp(False)
    assert rec["argument_size_in_bytes"] == specs.argument_bytes(args)
    assert rec["device_bytes_total"] == (rec["argument_size_in_bytes"]
                                         + rec["temp_size_in_bytes"])
    assert rec["output_size_in_bytes"] > 0 and rec["temp_size_in_bytes"] > 0
    assert 0 < rec["compute_bytes"] <= rec["hlo_bytes"]
    assert 0 < rec["compute_peak_bytes"] <= rec["device_bytes_total"]
    assert rec["decode_attention_calls"] == CELLS[cell]
    b = SHAPES[shape]["global_batch"]
    n_data = 32 if mesh == "multi" else 16
    assert rec["rank_rows"] == (b // n_data if b % n_data == 0 else b)
    census = rec["collectives"]
    assert census["total_bytes"] == sum(census[k]["bytes"]
                                        for k in COLLECTIVES)


def test_qwen3_decode_flops_are_the_closed_form(records):
    """2 x rows x the matmul parameters (attention and MLP projections of
    each layer, and the tied unembedding over the padded vocabulary),
    plus the attention: 4 x rows x S x Hq x D a layer, every row full;
    all of it split 16 ways by the tensor-parallel step: each product's
    output columns (and the vocabulary rows) and each row's positions
    (8 KV heads on 16 'model' ranks put the sequence there)."""
    rec = records[0][("qwen3-0.6b", "decode_32k", "single")]
    cfg = get_config("qwen3-0.6b", "full")
    d, hq, hkv, dh, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.d_head, cfg.d_ff)
    rows, s = 128 // 16, SHAPES["decode_32k"]["seq_len"]
    per_layer = d * hq * dh + 2 * d * hkv * dh + hq * dh * d + 3 * d * ff
    matmul = LAYERS * per_layer + cfg.padded_vocab * d
    want = 2 * rows * matmul + LAYERS * 4 * rows * s * hq * dh
    assert want % 16 == 0
    assert rec["hlo_flops"] == want // 16


def _train_census(cfg, mesh, rows: int, seq: int, n: int = 16) -> dict:
    """Rank 0's collectives in qwen3-0.6b's tensor-parallel train step
    (``rows`` rows of ``seq`` positions, 'model' of ``n``, bf16), by type
    as (count, output bytes): the prefill rule's forward and its adjoint
    backward, the vocab-parallel cross-entropy, and each gradient taken
    to the optimizer layout and each update back."""
    bf16, f32 = 2, 4
    d, dh = cfg.d_model, cfg.d_head
    out = {k: [] for k in ("all-gather", "reduce-scatter", "all-reduce",
                           "all-to-all")}
    act, loc = rows * seq * d * bf16, rows * seq // n * d * bf16
    model = Model(cfg, "meta")
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    p_sh = sharding.param_shardings(model, mesh)
    z_sh = sharding.param_shardings(model, mesh, zero=True)
    sharding.FALLBACK_LOG.clear()

    def local(name, placements):
        split = math.prod(mesh.shape[ax] for ax, pl
                          in zip(mesh.axis_names, placements) if pl.is_shard())
        return math.prod(shapes[name]) * bf16 // split

    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        # the sub-blocks' sequence gathers and their reduce-scatters, each
        # with its adjoint in the backward; the split norm scales gathered
        # whole and their gradients reduce-scattered back
        out["all-gather"] += [act] * 4
        out["reduce-scatter"] += [loc] * 4
        for norm in ("ln1", "ln2", "attn.q_norm", "attn.k_norm"):
            out["all-gather"].append(local(pre + norm, []))
            out["reduce-scatter"].append(local(pre + norm,
                                               p_sh[pre + norm].placements))
        # the KV heads' columns of wk, wv and the rows of wo and w_down,
        # forward and backward alike
        kv = max(cfg.n_kv_heads // n, 1) * dh * d * bf16
        rows_wo = cfg.n_heads * dh // n * d * bf16
        rows_down = cfg.d_ff // n * d * bf16
        out["all-to-all"] += [kv, kv, rows_wo, rows_down] * 2
    # the embedding's reduce-scatter and the head's gather, with adjoints
    out["all-gather"] += [act, act]
    out["reduce-scatter"] += [loc, loc]
    # the cross-entropy: the max, the sums and their adjoint
    out["all-reduce"] += [rows * seq * f32, 2 * rows * seq * f32,
                          2 * rows * seq * f32]
    for name in shapes:
        p, z = p_sh[name].placements, z_sh[name].placements
        grad = [pl if pl.is_shard() else "partial" for pl in p]
        for ax, (g, zz) in enumerate(zip(grad, z)):
            if g == "partial":              # summed over the axis
                out["reduce-scatter" if zz.is_shard() else "all-reduce"
                    ].append(None)
            if zz.is_shard() and not p[ax].is_shard():   # the update back
                out["all-gather"].append(local(name, p))
    out["all-reduce"] += [f32] * 4          # the norm, loss, ce and aux
    return out


def test_train_collectives_follow_the_layouts(records):
    """qwen3-0.6b's tensor-parallel train step at 2 layers, rank 0 of
    (16, 16) with 16 rows of 4096 positions: every collective of
    `_train_census` by type and count, and, for the activations' and the
    weights' pieces, the bytes: per layer four sequence all-gathers of
    the rows' every position (two forward, two the backward's adjoints
    of the reduce-scatters) and four reduce-scatters onto the rank's
    positions, the split norm scales gathered whole (their gradients
    reduce-scattered back), the all-to-alls of the KV heads' columns and
    of wo's and w_down's rows, forward and backward; the embedding's and
    the head's pair; the cross-entropy's three all-reduces (a max, the
    sums of exp and of the gold logits, their adjoint); each gradient
    summed over 'data' (and over 'model' where it is replicated there)
    by one redistribution to the ZeRO layout, a reduce-scatter where that
    splits a dim, else an all-reduce; each update all-gathered back over
    'data'; the norm and the three metrics. No gradient is all-reduced
    whole and no parameter is gathered whole but the norm scales. The
    step reads none of the model's parameters."""
    rec = records[0][("qwen3-0.6b", "train_4k", "single")]
    assert rec["reads_model_params"] is False
    cfg = specs._reduce_layers(get_config("qwen3-0.6b", "full"), LAYERS)
    want = _train_census(cfg, _mesh("single"), 16,
                         SHAPES["train_4k"]["seq_len"])
    census = rec["collectives"]
    for kind, sizes in want.items():
        assert census[kind]["count"] == len(sizes), kind
    for kind in ("all-gather", "all-to-all"):
        assert census[kind]["bytes"] == sum(want[kind]), kind
    known = sum(b for b in want["reduce-scatter"] if b is not None)
    grads = census["reduce-scatter"]["bytes"] - known
    matrices = sum(math.prod(p.shape) * 2 for p in Model(cfg, "meta")
                   .parameters() if p.dim() == 2) // 256
    assert matrices <= grads < matrices + 2 ** 16
    assert census["collective-permute"] == {"count": 0, "bytes": 0}
    assert census["all-reduce"]["bytes"] < 2 ** 21


def test_qwen3_train_flops_are_the_closed_form(records):
    """qwen3-0.6b's 2-layer train_4k record: FLOPs exactly three times the
    forward's products (the backward's two products a forward one) on
    the rank's shard of the work, 16 rows of 4096 positions: its q head
    of wq and rows of wo, its 192 ff columns, its 9504 vocabulary rows,
    the attention of its q head over every position (the chunked
    attention scores the causal mask's every entry) and the whole KV
    head it reads (8 KV heads on 16 ranks: 128 columns of wk and wv, not
    64). That is the one-process step's / 16 plus the KV heads: 1.9 %
    over at 2 layers, 5.5 % at 28, where the layers outweigh the head."""
    rec = records[0][("qwen3-0.6b", "train_4k", "single")]
    cfg = get_config("qwen3-0.6b", "full")
    d, hq, hkv, dh, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, cfg.d_ff, cfg.padded_vocab)
    n, rows, s = 16, 256 // 16, SHAPES["train_4k"]["seq_len"]
    t = rows * s
    layer = (2 * t * d * hq * dh // n + 2 * 2 * t * d * max(hkv // n, 1) * dh
             + 4 * rows * s * s * (hq // n) * dh + 2 * t * hq * dh // n * d
             + 3 * 2 * t * d * ff // n)
    want = 3 * (LAYERS * layer + 2 * t * d * v // n)
    assert rec["hlo_flops"] == want
    naive = 3 * (LAYERS * (2 * t * d * (2 * hq * dh + 2 * hkv * dh + 3 * ff)
                           + 4 * rows * s * s * hq * dh)
                 + 2 * t * d * v) // n
    assert 1.019 < want / naive < 1.02


def test_qwen3_prefill_record_at_full_depth_holds_no_full_logits(records):
    """qwen3-0.6b's prefill_32k at full depth (28 layers) through the CLI
    against the module's 2-layer record: every layer alike, so the
    FLOPs, each collective's count and bytes grow by 14 x the 2-layer
    record's layers (a layer: two sequence all-gathers, two
    reduce-scatters, four all-to-alls and its four norm scales; the
    fixed part: the embedding's reduce-scatter, the last position's
    all-reduce and the logits' all-gather, and the last position's
    unembedding), and the temporaries are one layer's peak, the 2-layer
    record's and below 4 GiB (the forward's logits of every position
    would be 65536 x 152064 float32, 40 GB). The step never reads the model's
    parameters, so the arguments are the rank's shards alone
    (`launch.specs`' sum)."""
    two = records[0][("qwen3-0.6b", "prefill_32k", "single")]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "prefill_32k", "--mesh", "single",
         "--out", str(records[1])],
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    full = json.loads((records[1] / "qwen3-0.6b__prefill_32k__single.json"
                       ).read_text())
    cfg = get_config("qwen3-0.6b", "full")
    _, args = specs.cell_lowerable("qwen3-0.6b", "prefill_32k",
                                   _mesh("single"))
    sharding.clear_mesh()
    assert full["argument_size_in_bytes"] == specs.argument_bytes(args)
    rows, d, v = 2, cfg.d_model, cfg.padded_vocab
    head = 2 * rows * d * v // 16
    layers = (two["hlo_flops"] - head) // LAYERS
    assert full["hlo_flops"] == head + cfg.n_layers * layers
    fixed = {"all-gather": (1, rows * v * 4),
             "reduce-scatter": (1, rows * 2048 * d * 2),
             "all-reduce": (1, rows * d * 2), "all-to-all": (0, 0)}
    for kind, (count, nbytes) in fixed.items():
        for key, base in (("count", count), ("bytes", nbytes)):
            per = (two["collectives"][kind][key] - base) // LAYERS
            assert full["collectives"][kind][key] == \
                base + cfg.n_layers * per, (kind, key)
    assert full["collectives"]["all-to-all"]["count"] == 4 * cfg.n_layers
    assert full["temp_size_in_bytes"] == two["temp_size_in_bytes"] < 2 ** 32


H100_BYTES = 85899345920                   # 80 GiB, one card's memory


def test_recurrentgemma_prefill_record_at_full_depth_fits_one_card(records):
    """recurrentgemma-2b's prefill_32k at full depth (26 layers) through
    the CLI: the tensor-parallel step runs every RG-LRU layer's scan on
    the rank's 160 of 2560 channels and every local attention from the
    rank's 2048 positions (10 q heads do not divide 16), so rank 0's
    temporaries lie below one H100's 80 GiB (the step that gathered
    every parameter and ran the whole forward held 107123441156 B). The
    arguments are the rank's shards alone (`launch.specs`' sum); that
    the step reads none of the model's parameters, the prefill census
    in test_torch_distributed.py holds at full width."""
    arch, shape = "recurrentgemma-2b", "prefill_32k"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(records[1])],
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((records[1] / f"{arch}__{shape}__single.json"
                      ).read_text())
    assert rec["ok"] and rec["n_layers_override"] is None
    _, args = specs.cell_lowerable(arch, shape, _mesh("single"))
    sharding.clear_mesh()
    assert rec["argument_size_in_bytes"] == specs.argument_bytes(args)
    assert rec["temp_size_in_bytes"] < H100_BYTES


def test_decode_records_show_the_cache_gather(records):
    """qwen3-0.6b's cache puts the sequence over 'model' (8 KV heads on
    16). The tensor-parallel step attends over the rank's 2048 positions
    and gathers no cache row (gathering the cache would move L x 8 x
    32768 x 8 x 128 bf16 for each of k and v): its all-gathers (activations and
    logits) stay below 32 MiB and its temporaries below 256 MiB, and the
    rank holds its arguments and little else."""
    rec = records[0][("qwen3-0.6b", "decode_32k", "single")]
    cache = LAYERS * 8 * 32768 * 8 * 128 * 2
    gathered = rec["collectives"]["all-gather"]["bytes"]
    assert gathered < 32 * 2 ** 20 < cache
    assert rec["temp_size_in_bytes"] < 256 * 2 ** 20
    assert rec["device_bytes_total"] < rec["argument_size_in_bytes"] \
        + 256 * 2 ** 20


FAMILY_CELLS = [c for c in CELLS if c[0] in ("mamba2-2.7b",
                                             "recurrentgemma-2b",
                                             "whisper-base")]


@pytest.mark.parametrize("cell", FAMILY_CELLS,
                         ids=["-".join(c[:2]) for c in FAMILY_CELLS])
def test_family_decode_records_gather_activations_only(records, cell):
    """The SSM, hybrid and encoder-decoder decode steps are tensor
    parallel: each record's all-gathers a step stay below 64 MiB
    (gathering every parameter and state row over 'model' would move
    3.5-6.8 GB a step at full depth on this mesh), and the step reads
    none of the model's own parameters, so the rank holds its arguments
    and its activations: temporaries below 256 MiB."""
    rec = records[0][cell]
    assert rec["collectives"]["all-gather"]["bytes"] < 64 * 2 ** 20
    assert rec["temp_size_in_bytes"] < 256 * 2 ** 20


def _dispatch_bytes(cfg, rows: int, experts: int) -> int:
    """One MoE layer's bf16 dispatch buffers at decode for ``experts``
    experts: the rank's ``rows`` tokens route as its whole rows of the
    global batch's grid (`moe.routing_grid`: decode_32k's 128 tokens make
    32 rows of 4, 2 a rank of 16 data ranks, 1 of 32), whose 4 k choices
    fill a capacity of max(4 k / E x capacity_factor, 4) rounded up to 8
    slots an expert (8 for dbrx and deepseek); a slot holds the token in
    and out (d each) and the swiglu FFN's gate, up and hidden
    (d_ff_expert each) in bf16, and the gate's silu in float32
    (d_ff_expert x 4 bytes)."""
    e, k = cfg.n_experts, cfg.top_k
    r, tl = routing_grid(rows, SHAPES["decode_32k"]["global_batch"] // rows)
    cap = max(int(tl * k / e * cfg.capacity_factor), 4)
    cap = (cap + 7) // 8 * 8
    slot = (2 * cfg.d_model + 3 * cfg.d_ff_expert) * 2 + cfg.d_ff_expert * 4
    return experts * r * cap * slot


@pytest.mark.parametrize("cell", [("dbrx-132b", "decode_32k", "multi"),
                                  ("deepseek-v3-671b", "decode_32k",
                                   "single")], ids=lambda c: c[0])
def test_moe_decode_records_hold_the_local_experts_buffers(records, cell):
    """The expert-parallel step fills dispatch buffers for the rank's E / 16
    experts alone and gathers no expert weight: its temporaries stay
    below twice the local buffers of one layer, plus the float32 logits
    and, for MLA, the float32 copy of the rank's latent cache rows. That
    bound lies below half of one layer's buffers for all E experts and
    well below one layer's expert weights, which a step building E x
    capacity buffers or gathering the experts would hold. (On the global
    grid a rank's buffers are a quarter of its own grid's: 1 row of 4
    tokens for 4 rows of 1 on the multi mesh, 2 of 4 for 8 of 1 on the
    single, at the same capacity of 8; the logits' and the latents'
    terms did not shrink, so the bound lies at 0.22 (dbrx) and 0.33
    (deepseek) of the E experts' buffers, where it lay under a
    quarter.)"""
    rec = records[0][cell]
    cfg = get_config(cell[0], "full")
    rows = rec["rank_rows"]
    local = _dispatch_bytes(cfg, rows, cfg.n_experts // 16)
    whole = _dispatch_bytes(cfg, rows, cfg.n_experts)
    latent = (rows * 32768 // 16 * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 4
              if cfg.use_mla else 0)
    bound = 2 * local + rows * cfg.vocab_size * 4 + latent
    experts = cfg.n_experts * 3 * cfg.d_model * cfg.d_ff_expert * 2
    assert bound < whole // 2 and bound < experts // 100
    temp = rec["temp_size_in_bytes"]
    assert 0 < temp < bound
    assert rec["device_bytes_total"] - rec["argument_size_in_bytes"] < bound
    assert rec["compute_peak_bytes"] - rec["argument_size_in_bytes"] < bound


def test_collective_census_on_a_dtensor_program():
    """A (64, 64) float32 meta DTensor, Shard(0) over 'model' of the
    (16, 16) mesh, gathered whole: one all-gather of 64 x 64 x 4 bytes
    out, nothing else."""
    script = textwrap.dedent("""
        import json, torch
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.distributed import sharding
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh
        dryrun._fake_group(256)
        mesh = sharding.device_mesh(make_production_mesh(), "cpu")
        x = DTensor.from_local(torch.empty(4, 64, device="meta"), mesh,
                               [Replicate(), Shard(0)],
                               shape=torch.Size((64, 64)), stride=(64, 1))
        counter = dryrun.OpCounter()
        with counter:
            y = x.full_tensor()
        assert tuple(y.shape) == (64, 64) and y.device.type == "meta"
        print(json.dumps(dryrun.collective_census(counter.collectives)))
        torch.distributed.destroy_process_group()
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, cwd=ROOT, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    census = json.loads(proc.stdout.strip().splitlines()[-1])
    assert census["all-gather"] == {"count": 1, "bytes": 64 * 64 * 4}
    for kind in COLLECTIVES[1:]:
        assert census[kind] == {"count": 0, "bytes": 0}
    assert census["total_bytes"] == 64 * 64 * 4


def test_router_reads_a_record_the_cli_wrote(records, tmp_path):
    """`roofline_token_latency` reads `{arch}__decode_32k__single.json`:
    max(flops / PEAK, bytes / HBM) / 128 from the record."""
    recs, out = records
    rec = recs[("qwen3-0.6b", "decode_32k", "single")]
    shutil.copy(out / f"qwen3-0.6b__decode_32k__single__L{LAYERS}.json",
                tmp_path / "qwen3-0.6b__decode_32k__single.json")
    want = max(rec["hlo_flops"] / PEAK_FLOPS_BF16,
               rec["hlo_bytes"] / HBM_BW) / 128
    assert router.roofline_token_latency("qwen3-0.6b", tmp_path) == want
    model = router.service_model("qwen3-0.6b", dryrun_dir=tmp_path)
    assert model.token_s_accel == want != router.analytic_token_latency(
        "qwen3-0.6b")


def test_decode_attention_on_meta_counts_its_cost():
    """The meta branch returns an empty (B, Hq, D) output in q's type on
    the meta device, launches nothing and adds the cost of a call with
    every row full; that cost, over the card's memory rate, is the bound
    chip_smoke.py printed for this shape."""
    shape = (8, 16, 8, 128, 32768)
    b, hq, hkv, d, s = shape
    q = torch.empty(b, hq, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, s, hkv, d, dtype=torch.bfloat16, device="meta")
    lengths = torch.empty(b, dtype=torch.int32, device="meta")
    before = dict(decode_attention.meta)
    launches = decode_attention.launches
    out = decode_attention(q, k, k, lengths)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device.type == "meta"
    assert decode_attention.launches == launches
    cost = decode_attention_cost(shape, [s] * b, 2)
    assert {key: decode_attention.meta[key] - before[key]
            for key in before} == {"calls": 1, **cost}
    assert math.isclose(cost["bytes"] / HBM_BW * 1e3, 0.32053951999999997,
                        rel_tol=1e-12)


def _chip_smoke():
    """chip_smoke.py as a module (it runs nothing on import)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(2, 4, 2, 16, 24), (3, 8, 1, 8, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_cost_is_the_calls_own(shape, dtype):
    """With every row full, the cost's FLOPs are FlopCounterMode's count
    of the plain version on the CPU (its two batched products) and its
    bytes those of q, k, v, the lengths and the output, each once. A
    ragged call costs what its rows cost as full calls of their own
    lengths (clipped to [0, S]). chip_smoke.py's bound takes its bytes
    and FLOPs from the cost."""
    from torch.utils.flop_counter import FlopCounterMode
    b, hq, hkv, d, s = shape
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, hq, d, generator=g).to(dtype)
    k, v = (torch.randn(b, s, hkv, d, generator=g).to(dtype)
            for _ in range(2))
    lengths = torch.full((b,), s, dtype=torch.int32)
    counter = FlopCounterMode(display=False)
    with counter:
        out = decode_attention(q, k, v, lengths)
    size = dtype.itemsize
    assert decode_attention_cost(shape, [s] * b, size) == {
        "flops": counter.get_total_flops(),
        "bytes": sum(t.numel() * t.element_size()
                     for t in (q, k, v, lengths, out))}
    lens = [0, s + 5, 7][:b] + [s // 2] * max(0, b - 3)
    rows = [decode_attention_cost((1, hq, hkv, d, min(max(n, 0), s)),
                                  [min(max(n, 0), s)], size) for n in lens]
    assert decode_attention_cost(shape, lens, size) == {
        key: sum(r[key] for r in rows) for key in ("flops", "bytes")}
    chip = _chip_smoke()
    bound = chip._decode_bound(shape, lens, size)
    cost = decode_attention_cost(shape, lens, size)
    assert {key: bound[key] for key in cost} == cost
    assert bound["bound_ms"] == max(cost["bytes"] / chip.HBM_BYTES_PER_S,
                                    cost["flops"] / chip.FP32_FLOPS) * 1e3
