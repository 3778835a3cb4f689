"""The `relax` reverse kernel's algebra on the CPU: the adjoint of n as a
scan of affine maps (`src/repro_torch/kernels/relax/csrc/relax.cu`).

The reverse step nbar <- a - dbar, a = nbar + dc/dn_new, dbar = a dn/ddelta
+ dc/ddelta, is nbar <- p_k nbar + q_k with p_k = 1 - dn/ddelta and q_k =
p_k dc/dn_new - dc/ddelta; no coefficient depends on nbar. `affine_grad`
below computes p_k and q_k from the plain loop's saved (n, delta, w) in
the working type, as the kernel does, and composes the maps in float64 in
the kernel's order: a Hillis-Steele scan inside groups of the warp width,
then over the groups' totals, then a carry from tile to tile, right to
left. Then dbar and the three gradient sums.

The inputs are one numpy trace (the port's b-model), summed into both
packages' specs; the reference's fleet comes across through `interop`.
K runs over one interval, the reference test's 60, the fast grid's 180,
the full grid's 720, and 2161 (six hours of 10 s intervals plus one),
which spans several of the kernel's tiles forward (1024) and reverse
(512) and is a multiple of neither; each K takes one of the five thetas
(`CASES`), so that every K and every theta is seen once. The kernel
itself is held at every K x theta on the card: by the card-only test
below and by `chip_smoke.py`'s `relax_kernel` phase. Tolerances: against autograd through
the plain loop rtol 1e-5 (float32; the composition is in float64, the
coefficients round in float32 at other places than autograd's) and 1e-10
(float64); against the reference's `jax.grad` under `jax.enable_x64` at
1e-10 in float64; across block sizes 1e-12 in float64 (only the order of
the float64 composition changes).
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.workers import DEFAULT_FLEET as REF_FLEET
from repro.policies import tune as ref_tune
from repro_torch import interop
from repro_torch.core.traces import synthetic_trace
from repro_torch.kernels.relax import ref
from repro_torch.policies import tune

KS = (1, 60, 180, 720, 2161)
# tests/test_policy_tune.py's three and a point on each projection bound
THETAS = ((0.5, 0.0, 0.9), (2.3, 0.7, 0.85), (7.0, 1.5, 0.65),
          (0.0, 0.0, 0.5), (3.0, 4.0, 1.0))
CASES = tuple(zip(KS, THETAS))      # (K, theta), one theta a K
RTOL = {"float32": 1e-5, "float64": 1e-10}
WARP = 32
THREADS = 512                       # the reverse kernel's block


@functools.cache
def _counts():
    tr = synthetic_trace(seed=0, bias=0.55, horizon_s=max(KS) * 10,
                         request_size_s=0.05, mean_demand_workers=100.0)
    return tr.counts, tr.request_size_s


def _spec(k: int, dtype: str):
    counts, size = _counts()
    spec = tune.make_spec(counts, size, interop.fleet_params(REF_FLEET),
                          dtype=getattr(torch, dtype), device="cpu")
    return spec._replace(demand=spec.demand[:k])


@functools.cache
def _plain(k: int, theta: tuple, dtype: str):
    """The plain loop's saved (n, delta, w) and autograd's gradient."""
    spec = _spec(k, dtype)
    th = torch.tensor(theta, dtype=getattr(torch, dtype), requires_grad=True)
    cost, n, delta, w = ref.relax_loop(th, spec.demand, tuple(spec[1:]))
    grad, = torch.autograd.grad(cost, th)
    return (n.detach(), delta.detach(), w.detach()), grad


def _scan_up(P: torch.Tensor, Q: torch.Tensor):
    """Inclusive Hillis-Steele scan of affine maps along the last axis:
    entry l becomes F_l o ... o F_0 (x -> P x + Q, entry 0 applied
    first), in log2 steps, as `__shfl_up_sync` does across lanes."""
    d = 1
    while d < P.shape[-1]:
        Pu, Qu = torch.ones_like(P), torch.zeros_like(Q)
        Pu[..., d:], Qu[..., d:] = P[..., :-d], Q[..., :-d]
        P, Q = P * Pu, P * Qu + Q
        d *= 2
    return P, Q


def _shift(P: torch.Tensor, Q: torch.Tensor):
    """Inclusive to exclusive along the last axis: the identity first."""
    Pe, Qe = torch.ones_like(P), torch.zeros_like(Q)
    Pe[..., 1:], Qe[..., 1:] = P[..., :-1], Q[..., :-1]
    return Pe, Qe


def _coeffs(theta: torch.Tensor, demand: torch.Tensor, consts, saved):
    """Per interval, in the working type as the kernel computes them and
    then widened: dc/dn_new, dc/ddelta, dn_new/ddelta, lam - lam_prev and
    lam_hat (float64, (K,) each)."""
    interval_s, spin_up_s, S, I_f, B_f, miss_weight, sharp = consts
    n, delta, w = saved
    dt = theta.dtype
    g = theta[1]
    interval = torch.tensor(interval_s, dtype=dt)
    lam = demand / (S * interval)
    lam_prev = torch.cat([lam[:1], lam[:-1]])
    oma = 1 - interval / (interval + spin_up_s)
    m = 1 - oma * w
    n_new = n + m * delta
    A = torch.tensor(I_f, dtype=dt) * interval
    B = torch.tensor(B_f * spin_up_s, dtype=dt)
    cm = torch.tensor(miss_weight, dtype=dt) * torch.tensor(S, dtype=dt) \
        * interval
    dc_dn = (A * torch.sigmoid(sharp * (n_new - lam))
             - cm * torch.sigmoid(sharp * (lam - n_new)))
    dc_dd = B * torch.sigmoid(sharp * delta)
    dn_dd = m - delta * oma * sharp * w * (1 - w)
    lam_hat = lam + g * (lam - lam_prev)
    return [x.double() for x in (dc_dn, dc_dd, dn_dd, lam - lam_prev,
                                 lam_hat)]


def _sums(theta, dbar, nbar_0, dlam, lam_hat) -> torch.Tensor:
    """The three gradient sums in float64, rounded to theta's type."""
    u = theta[2].double()
    return torch.stack([dbar.sum() + nbar_0, (dbar * dlam / u).sum(),
                        -(dbar * lam_hat / (u * u)).sum()]).to(theta.dtype)


def affine_grad(theta: torch.Tensor, demand: torch.Tensor, consts, saved,
                threads: int = THREADS, warp: int = WARP) -> torch.Tensor:
    """dcost/dtheta (3,) in theta's type from the forward's saved (n,
    delta, w), by the reverse kernel's scan: coefficients in the working
    type, maps composed and sums taken in float64."""
    dc_dn, dc_dd, dn_dd, dlam, lam_hat = _coeffs(theta, demand, consts,
                                                 saved)
    P = 1.0 - dn_dd
    Q = P * dc_dn - dc_dd
    # the reverse's order (k = K-1 first), padded with the identity to
    # whole tiles: (tiles, warps a tile, lanes)
    k = demand.shape[0]
    tiles = -(-k // threads)
    pad = tiles * threads - k
    Pr = torch.cat([P.flip(0), torch.ones(pad, dtype=torch.float64)])
    Qr = torch.cat([Q.flip(0), torch.zeros(pad, dtype=torch.float64)])
    Pl, Ql = _scan_up(Pr.view(tiles, -1, warp), Qr.view(tiles, -1, warp))
    Pw, Qw = _scan_up(Pl[..., -1], Ql[..., -1])       # over warps' totals
    Pwe, Qwe = _shift(Pw, Qw)
    Ple, Qle = _shift(Pl, Ql)
    nbar = torch.empty(tiles, threads // warp, warp, dtype=torch.float64)
    carry = torch.zeros((), dtype=torch.float64)
    for t in range(tiles):
        at_warp = Pwe[t] * carry + Qwe[t]
        nbar[t] = Ple[t] * at_warp[:, None] + Qle[t]
        carry = Pw[t, -1] * carry + Qw[t, -1]
    nbar = nbar.reshape(-1)[:k].flip(0)               # reaching each k
    dbar = (nbar + dc_dn) * dn_dd + dc_dd
    return _sums(theta, dbar, carry, dlam, lam_hat)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k,theta", CASES)
def test_affine_scan_matches_autograd(k, theta, dtype):
    spec = _spec(k, dtype)
    saved, want = _plain(k, theta, dtype)
    th = torch.tensor(theta, dtype=getattr(torch, dtype))
    got = affine_grad(th, spec.demand, tuple(spec[1:]), saved)
    assert got.dtype == th.dtype and got.shape == (3,)
    torch.testing.assert_close(got, want, rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("k,theta", CASES)
def test_affine_scan_matches_reference_float64(k, theta):
    counts, size = _counts()
    with jax.enable_x64(True):
        spec = ref_tune.make_spec(counts, size, REF_FLEET,
                                  dtype=jnp.float64)
        spec = spec._replace(demand=spec.demand[:k])
        want = np.asarray(ref_tune.relaxed_grad(
            jnp.asarray(theta, jnp.float64), spec))
    assert want.dtype == np.float64
    port = _spec(k, "float64")
    np.testing.assert_array_equal(port.demand.numpy(),
                                  np.asarray(spec.demand))
    saved, _ = _plain(k, theta, "float64")
    got = affine_grad(torch.tensor(theta, dtype=torch.float64), port.demand,
                      tuple(port[1:]), saved)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL["float64"],
                               atol=0)


@pytest.mark.parametrize("threads,warp", [(64, 32), (1024, 32), (512, 8)])
def test_affine_scan_does_not_depend_on_the_block(threads, warp):
    """Another block or group width only reorders the float64
    composition: the gradient moves by rounding alone."""
    k, theta = max(KS), THETAS[2]
    spec = _spec(k, "float64")
    saved, _ = _plain(k, theta, "float64")
    th = torch.tensor(theta, dtype=torch.float64)
    consts = tuple(spec[1:])
    base = affine_grad(th, spec.demand, consts, saved)
    other = affine_grad(th, spec.demand, consts, saved, threads, warp)
    torch.testing.assert_close(other, base, rtol=1e-12, atol=0)


def test_affine_scan_equals_the_sequential_adjoint():
    """The scan against the adjoint walked one interval at a time, from
    the same coefficients: a = nbar + dc/dn_new, dbar = a dn/ddelta +
    dc/ddelta, nbar = a - dbar, from nbar = 0 after the last interval."""
    k, theta = 720, THETAS[1]
    spec = _spec(k, "float64")
    saved, _ = _plain(k, theta, "float64")
    th = torch.tensor(theta, dtype=torch.float64)
    consts = tuple(spec[1:])
    dc_dn, dc_dd, dn_dd, dlam, lam_hat = _coeffs(th, spec.demand, consts,
                                                 saved)
    nbar, dbar = 0.0, torch.empty(k, dtype=torch.float64)
    for i in range(k - 1, -1, -1):
        a = nbar + float(dc_dn[i])
        dbar[i] = a * float(dn_dd[i]) + float(dc_dd[i])
        nbar = a - float(dbar[i])
    walked = _sums(th, dbar, nbar, dlam, lam_hat)
    scanned = affine_grad(th, spec.demand, consts, saved)
    torch.testing.assert_close(scanned, walked, rtol=1e-12, atol=0)


def test_cuda_kernels_match_the_scan_and_the_plain_loop():
    """On the card: the forward kernel's saved buffers against the plain
    loop's (over max |n|, and sharp / 4 x that for w), and the reverse
    kernel's gradient against `affine_grad` on the kernel's own saved
    buffers, at every K x theta in both types."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU build)")
    from repro_torch.kernels.relax import ops
    for k, theta, (dtype, rtol) in itertools.product(KS, THETAS,
                                                     RTOL.items()):
        spec = _spec(k, dtype)
        consts = tuple(spec[1:])
        th = torch.tensor(theta, dtype=getattr(torch, dtype))
        _, *saved = ops.relax_forward(th.cuda(), spec.demand.cuda(), consts)
        grad = ops.relax_backward(th.cuda(), spec.demand.cuda(), consts,
                                  saved, torch.ones((), device="cuda"))
        saved = [t.cpu() for t in saved]
        want_saved, _ = _plain(k, theta, dtype)
        scale = float(want_saved[0].abs().max())
        for got, want, s in zip(saved, want_saved,
                                (scale, scale, spec.sharp / 4 * scale)):
            assert float((got - want).abs().max()) <= rtol * s
        torch.testing.assert_close(
            grad.cpu(), affine_grad(th, spec.demand, consts, saved),
            rtol=rtol, atol=0)
