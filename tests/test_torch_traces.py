"""Port traces vs the reference.

The reference's b-model draws its coin flips with `jax.random`, which
the port cannot reproduce, so the port's cascade is held to the
reference by distribution: volume conserved, mean rate, and burstiness
statistics averaged over many seeds. Everything drawn from numpy
(per-app sizes, demands, biases, Poisson counts) must be equal exactly.
"""

import numpy as np
import pytest

import repro.workloads.scenarios as ref_scen
from repro.core import bmodel as rbm
from repro_torch.core import bmodel as pbm
from repro_torch.core import traces as ptr
import repro_torch.workloads.scenarios as port_scen


@pytest.mark.parametrize("bias,levels,seed", [(0.5, 1, 0), (0.6, 7, 3),
                                              (0.68, 10, 11), (0.75, 12, 5)])
def test_bmodel_volume_conserved_and_nonnegative(bias, levels, seed):
    s = pbm.bmodel_series(np.random.default_rng(seed), bias, levels, 1000.0)
    assert s.shape == (2 ** levels,) and s.dtype == np.float32
    assert np.all(s >= 0)
    np.testing.assert_allclose(s.sum(), 1000.0, rtol=1e-4)


def test_bmodel_uniform_at_half():
    s = pbm.bmodel_series(np.random.default_rng(0), 0.5, 8, 256.0)
    np.testing.assert_allclose(s, np.ones(256), rtol=1e-5)


def test_bmodel_mean_rate_and_seed_determinism():
    r = pbm.bmodel_rates_np(2, 0.7, 4096, 123.0)
    np.testing.assert_allclose(r.mean(), 123.0, rtol=1e-3)
    np.testing.assert_array_equal(r, pbm.bmodel_rates_np(2, 0.7, 4096, 123.0))
    assert not np.array_equal(r, pbm.bmodel_rates_np(3, 0.7, 4096, 123.0))


def _burstiness(rates):
    ratio = (rates[1:] + 1e-9) / (rates[:-1] + 1e-9)
    return rates.std() / rates.mean(), np.log(np.maximum(ratio, 1 / ratio)).mean()


@pytest.mark.parametrize("bias", [0.6, 0.7])
def test_bmodel_burstiness_matches_reference_distribution(bias):
    """Coefficient of variation and mean log jump between consecutive
    seconds, averaged over 24 seeds, within 10% of the reference's."""
    port = np.mean([_burstiness(pbm.bmodel_rates_np(s, bias, 1024, 100.0))
                    for s in range(24)], axis=0)
    ref = np.mean([_burstiness(rbm.bmodel_rates_np(s, bias, 1024, 100.0))
                   for s in range(24)], axis=0)
    np.testing.assert_allclose(port, ref, rtol=0.10)


def test_bmodel_high_burstiness_has_large_consecutive_jumps():
    r = pbm.bmodel_rates_np(1, 0.75, 4096, 100.0)
    ratio = (r[1:] + 1e-9) / (r[:-1] + 1e-9)
    assert max(ratio.max(), (1 / ratio).max()) > 20.0


def _recorder(module, trace_cls, calls):
    def fake(seed, bias=0.6, horizon_s=7200, request_size_s=0.05,
             mean_demand_workers=100.0, name=None):
        calls.append((seed, bias, horizon_s, request_size_s,
                      mean_demand_workers, name))
        return trace_cls(name, request_size_s, np.zeros(horizon_s))
    return fake


@pytest.mark.parametrize("source,bucket", [("azure", "short"),
                                           ("alibaba", "medium")])
def test_production_like_apps_draws_match_reference(monkeypatch, source,
                                                    bucket):
    """Per-app seeds, biases, sizes and mean demands are the reference's,
    draw for draw (recorded at the synthetic_trace call)."""
    got, want = [], []
    monkeypatch.setattr(port_scen, "synthetic_trace",
                        _recorder(port_scen, port_scen.Trace, got))
    monkeypatch.setattr(ref_scen, "synthetic_trace",
                        _recorder(ref_scen, ref_scen.Trace, want))
    p = port_scen.production_like_apps(source, bucket, seed=1, horizon_s=600)
    r = ref_scen.production_like_apps(source, bucket, seed=1, horizon_s=600)
    assert got == want and len(got) == ref_scen.TABLE7[source][bucket]
    assert [t.meta for t in p] == [t.meta for t in r]


def test_table7_constants_and_missing_bucket():
    assert ptr.TABLE7 == ref_scen.TABLE7
    assert ptr.BUCKETS_S == ref_scen.BUCKETS_S
    assert ptr.SOURCE_BIAS == ref_scen.SOURCE_BIAS
    with pytest.raises(ValueError, match="no long bucket"):
        ptr.alibaba_like_apps("long")
    assert len(ptr.azure_like_apps("short", horizon_s=120)) == 13


def test_synthetic_trace_shape_and_counts_follow_reference():
    """Same horizon, size and meta as the reference, and the Poisson
    counts the reference would draw from the port's rates."""
    kw = dict(seed=4, bias=0.65, horizon_s=600, request_size_s=0.05,
              mean_demand_workers=10.0)
    p, r = ptr.synthetic_trace(**kw), ref_scen.synthetic_trace(**kw)
    assert (p.name, p.request_size_s, p.horizon_s, p.meta) == (
        r.name, r.request_size_s, r.horizon_s, r.meta)
    twin = ref_scen.Trace("twin", p.request_size_s, p.rates_per_s)
    np.testing.assert_array_equal(p.counts, twin.sample_counts(4 + 17))
    np.testing.assert_allclose(p.rates_per_s.mean(), r.rates_per_s.mean(),
                               rtol=0.5)


def test_trace_methods_match_reference():
    rates = np.random.default_rng(0).uniform(0, 20, 50)
    p = port_scen.Trace("x", 0.02, rates)
    r = ref_scen.Trace("x", 0.02, rates)
    np.testing.assert_array_equal(p.sample_counts(7), r.sample_counts(7))
    np.testing.assert_array_equal(p.arrival_times(7), r.arrival_times(7))
    assert p.deadline == r.deadline == 0.2
    assert p.total_work_cpu_s() == r.total_work_cpu_s()
