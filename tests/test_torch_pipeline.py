"""The port's ``StreamingAggregator.add`` / ``add_batch`` and
``streaming_rounds`` against ``repro.core.pipeline``, mirroring
tests/test_pipeline_streaming.py: single, batched and weighted folds on
integer-valued payloads, where every f32 sum is exact, so both packages
and every batch split give the same bits; Gaussian payloads through the
kernel path to rtol 1e-5 / atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.core import pipeline as ref_pipeline
from repro_torch.core import pipeline
from repro_torch.kernels import fedavg_accum as fa


def _int_data(seed, k, n, w):
    rng = np.random.default_rng(seed)
    pk = rng.integers(-8, 9, (k, n, w)).astype(np.float32)
    m = (rng.random((k, n)) > 0.2).astype(np.float32)
    return pk, m


def _both(n, w, use_kernel=True):
    return (ref_pipeline.StreamingAggregator(n, w, use_kernel=use_kernel),
            pipeline.StreamingAggregator(n, w, use_kernel=use_kernel,
                                         device="cpu"))


def _same(agg_ref, agg, exact=True):
    for got, want in ((agg.total, agg_ref.total),
                      (agg.counts, agg_ref.counts),
                      (agg.finalize(), agg_ref.finalize())):
        if exact:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 7), (2, 20)])
def test_single_adds_bit_match_reference_and_batch_aggregate(seed, k):
    pk, m = _int_data(seed, k, 6, 32)
    agg_ref, agg = _both(6, 32)
    for i in range(k):
        agg_ref.add(jnp.asarray(pk[i]), jnp.asarray(m[i]))
        agg.add(pk[i], m[i])
    _same(agg_ref, agg)
    expect, _ = ref_agg.masked_aggregate(jnp.asarray(pk), jnp.asarray(m))
    np.testing.assert_array_equal(agg.finalize().numpy(), np.asarray(expect))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("split", [(13,), (6, 7), (4, 4, 5), (1, 12)])
def test_batched_adds_bit_match(split, use_kernel):
    pk, m = _int_data(0, sum(split), 10, 128)
    agg_ref, agg = _both(10, 128, use_kernel)
    off = 0
    for b in split:
        agg_ref.add(jnp.asarray(pk[off:off + b]), jnp.asarray(m[off:off + b]))
        agg.add(pk[off:off + b], m[off:off + b])
        off += b
    _same(agg_ref, agg)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_weighted_batched_adds_bit_match(use_kernel):
    pk, m = _int_data(1, 9, 5, 64)
    wts = np.random.default_rng(1).integers(1, 5, (9,)).astype(np.float32)
    agg_ref, agg = _both(5, 64, use_kernel)
    for sl in (slice(0, 4), slice(4, 9)):
        agg_ref.add_batch(jnp.asarray(pk[sl]), jnp.asarray(m[sl]),
                          jnp.asarray(wts[sl]))
        agg.add_batch(pk[sl], m[sl], wts[sl])
    _same(agg_ref, agg)


def test_mixed_single_and_batched_adds():
    pk, m = _int_data(2, 11, 7, 32)
    agg_ref, agg = _both(7, 32)
    for a, wrap in ((agg_ref, jnp.asarray), (agg, lambda x: x)):
        a.add(wrap(pk[0]), wrap(m[0]), 2.0)          # single upload
        a.add(wrap(pk[1:5]), wrap(m[1:5]))           # ndim 3: a batch
        a.add_batch(wrap(pk[5:]), wrap(m[5:]), 1.0)  # scalar batch weight
    _same(agg_ref, agg)


def test_scalar_weight_on_batch_broadcasts():
    pk, m = _int_data(3, 6, 4, 32)
    a1 = pipeline.StreamingAggregator(4, 32, device="cpu")
    a1.add_batch(pk, m, 3.0)
    a2 = pipeline.StreamingAggregator(4, 32, device="cpu")
    a2.add_batch(pk, m, torch.full((6,), 3.0))
    assert torch.equal(a1.finalize(), a2.finalize())


def test_gaussian_batches_through_the_kernel_path():
    rng = np.random.default_rng(4)
    pk = rng.normal(size=(12, 9, 40)).astype(np.float32)
    m = (rng.random((12, 9)) > 0.2).astype(np.float32)
    wts = rng.integers(1, 4, 12).astype(np.float32)
    agg_ref, agg = _both(9, 40)
    before = fa.fedavg_accum.launches
    for sl in (slice(0, 5), slice(5, 12)):
        agg_ref.add_batch(jnp.asarray(pk[sl]), jnp.asarray(m[sl]),
                          jnp.asarray(wts[sl]))
        agg.add_batch(pk[sl], m[sl], wts[sl])
    _same(agg_ref, agg, exact=False)
    assert fa.fedavg_accum.launches == before        # CPU: plain version


def test_streaming_rounds_accepts_batches():
    pk, m = _int_data(4, 8, 6, 32)
    items = [(pk[:3], m[:3]), (pk[3], m[3]), (pk[4:], m[4:])]
    want = ref_pipeline.streaming_rounds(
        iter([(jnp.asarray(p), jnp.asarray(x)) for p, x in items]), 6, 32)
    got = pipeline.streaming_rounds(iter(items), 6, 32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_finalize_after_reset():
    s = pipeline.StreamingAggregator(4, 8, device="cpu")
    s.add(torch.ones((4, 8)), torch.ones(4))
    assert torch.equal(s.finalize(), torch.ones((4, 8)))
    with pytest.raises(AssertionError):
        s.add(torch.ones((4, 8)), torch.ones(4))      # finalized
    with pytest.raises(AssertionError):
        s.add_batch(torch.ones((1, 4, 8)), torch.ones((1, 4)))
    s.reset()
    assert not s.finalize().any()                     # empty round -> 0
    s.reset()
    s.add(2 * torch.ones((4, 8)), torch.ones(4))
    assert torch.equal(s.finalize(), torch.full((4, 8), 2.0))


def test_streaming_rounds_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        pipeline.streaming_rounds(iter([]), 2, 4)
