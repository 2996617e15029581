"""The port's FedAvg accumulation kernels (#3 ``fedavg_accum`` and #4
``quantized_accum``: their plain versions and CPU wrappers), the ``ops``
wrappers and the oracles, held against the JAX package's Pallas kernels
(``repro.kernels.ops``, interpret mode) and ``repro.kernels.ref``.

Bitwise on integer-valued payloads and power-of-two q8 scales, where
every f32 sum is exact; rtol 1e-5 / atol 1e-6 on Gaussian payloads, where
the two packages may sum a client block in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import fedavg_accum as fa
from repro_torch.kernels import ops
from repro_torch.kernels import quantized_accum as qa
from repro_torch.kernels import ref

# tests/test_kernels.py's shapes (C not a multiple of 8, K=1, K > 8) and
# the wire's own width, which is no multiple of 128
SHAPES = [(1, 8, 128), (4, 8, 128), (10, 24, 512), (32, 16, 256),
          (3, 7, 128), (10, 1, 512), (10, 5, 367)]


def _inputs(kcw, integer, seed=0):
    K, C, W = kcw
    rng = np.random.default_rng(seed + K * 1000 + C * 10 + W)
    pk = (rng.integers(-8, 9, (K, C, W)) if integer
          else rng.normal(size=(K, C, W))).astype(np.float32)
    m = (rng.random((K, C)) > 0.2).astype(np.float32)
    m *= rng.integers(1, 4, (K, 1)).astype(np.float32)   # n_k weights
    m[:, 0] = 0.0                                        # a zero-count row
    return pk, m


def _q8_inputs(kcw, pow2, seed=0):
    K, C, W = kcw
    rng = np.random.default_rng(seed + K * 1000 + C * 10 + W)
    q = rng.integers(-127, 128, (K, C, W)).astype(np.int8)
    # uniform scales keep |q * s| < 1, the Gaussian payloads' magnitude,
    # so that atol 1e-6 means the same for both
    s = ((2.0 ** rng.integers(-6, 0, (K, C))) if pow2
         else rng.random((K, C)) / 127).astype(np.float32)
    m = (rng.random((K, C)) > 0.2).astype(np.float32)
    m *= rng.integers(1, 4, (K, 1)).astype(np.float32)
    m[:, 0] = 0.0
    return q, s, m


def _check(got, want, exact):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want).reshape(got.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kcw", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("finalize", [True, False], ids=["avg", "raw"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
def test_fedavg_accum_plain_matches_pallas(kcw, dtype, finalize, integer):
    pk, m = _inputs(kcw, integer)
    want, wcnt = ref_ops.fedavg_accum(jnp.asarray(pk, dtype), jnp.asarray(m),
                                      finalize=finalize)
    x = torch.from_numpy(pk).to(getattr(torch, dtype))
    got, cnt = fa.fedavg_accum_plain(x, torch.from_numpy(m),
                                     finalize=finalize)
    # bf16 rounds Gaussian payloads alike in both packages; the integer
    # payloads in [-8, 8] are exact in bf16
    _check(got, want, integer)
    _check(cnt, wcnt, True)
    assert got.dtype == torch.float32 and cnt.shape == (kcw[1],)


@pytest.mark.parametrize("kcw", SHAPES, ids=str)
@pytest.mark.parametrize("finalize", [True, False], ids=["avg", "raw"])
@pytest.mark.parametrize("pow2", [True, False], ids=["pow2", "uniform"])
def test_quantized_accum_plain_matches_pallas(kcw, finalize, pow2):
    q, s, m = _q8_inputs(kcw, pow2)
    want, wcnt = ref_ops.quantized_accum(jnp.asarray(q), jnp.asarray(s),
                                         jnp.asarray(m), finalize=finalize)
    got, cnt = qa.quantized_accum_plain(torch.from_numpy(q),
                                        torch.from_numpy(s),
                                        torch.from_numpy(m),
                                        finalize=finalize)
    _check(got, want, pow2)
    _check(cnt, wcnt, True)


@pytest.mark.parametrize("finalize", [True, False], ids=["avg", "raw"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
def test_oracles_match_reference_oracles(finalize, integer):
    pk, m = _inputs((6, 9, 40), integer)
    want = ref_ref.fedavg_accum_ref(jnp.asarray(pk), jnp.asarray(m),
                                    finalize=finalize)
    got = ref.fedavg_accum_ref(torch.from_numpy(pk), torch.from_numpy(m),
                               finalize=finalize)
    for g, w in zip(got, want):
        _check(g, w, integer)
    q, s, m = _q8_inputs((6, 9, 40), pow2=integer)
    want = ref_ref.quantized_accum_ref(jnp.asarray(q), jnp.asarray(s),
                                       jnp.asarray(m), finalize=finalize)
    got = ref.quantized_accum_ref(torch.from_numpy(q), torch.from_numpy(s),
                                  torch.from_numpy(m), finalize=finalize)
    for g, w in zip(got, want):
        _check(g, w, integer)


@pytest.mark.parametrize("kcw", [(3, 7, 128), (10, 5, 367)], ids=str)
@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
def test_fedavg_accum_into_matches_reference(kcw, integer):
    pk, m = _inputs(kcw, integer)
    rng = np.random.default_rng(1)
    total = (rng.integers(-8, 9, kcw[1:]) if integer
             else rng.normal(size=kcw[1:])).astype(np.float32)
    counts = rng.integers(0, 3, kcw[1]).astype(np.float32)
    want_t, want_c = ref_ops.fedavg_accum_into(
        jnp.asarray(total), jnp.asarray(counts), jnp.asarray(pk),
        jnp.asarray(m))
    t, c = torch.from_numpy(total.copy()), torch.from_numpy(counts.copy())
    out = ops.fedavg_accum_into(t, c, torch.from_numpy(pk),
                                torch.from_numpy(m))
    assert out[0] is t and out[1] is c           # in place
    _check(t, want_t, integer)
    _check(c, want_c, True)


def test_zero_count_rows_are_zero_in_both_packages():
    pk, m = _inputs((5, 6, 32), True)
    m[:, 2] = 0.0
    want, _ = ref_ops.fedavg_accum(jnp.asarray(pk), jnp.asarray(m))
    got, cnt = ops.fedavg_accum(torch.from_numpy(pk), torch.from_numpy(m))
    _check(got, want, True)
    assert not got[0].any() and not got[2].any()
    assert cnt[0] == 0 and cnt[2] == 0
    q, s, _ = _q8_inputs((5, 6, 32), True)
    got, cnt = ops.quantized_accum(torch.from_numpy(q), torch.from_numpy(s),
                                   torch.from_numpy(m))
    assert not got[0].any() and not got[2].any() and cnt[2] == 0


@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_ops_casts_other_payload_types_like_the_reference(dtype):
    pk, m = _inputs((4, 5, 16), False)
    want, wcnt = ref_ops.fedavg_accum(
        jnp.asarray(pk.astype(dtype)), jnp.asarray(m))
    got, cnt = ops.fedavg_accum(torch.from_numpy(pk.astype(dtype)),
                                torch.from_numpy(m))
    _check(got, want, False)
    _check(cnt, wcnt, True)


def test_cpu_wrappers_run_plain_versions_without_launching():
    pk, m = _inputs((9, 4, 24), False)
    q, s, _ = _q8_inputs((9, 4, 24), False)
    x, mm = torch.from_numpy(pk), torch.from_numpy(m)
    before = (fa.fedavg_accum.launches, qa.quantized_accum.launches)
    for fin in (True, False):
        for g, w in zip(fa.fedavg_accum(x, mm, finalize=fin),
                        fa.fedavg_accum_plain(x, mm, finalize=fin)):
            assert torch.equal(g, w)
        args = (torch.from_numpy(q), torch.from_numpy(s), mm)
        for g, w in zip(qa.quantized_accum(*args, finalize=fin),
                        qa.quantized_accum_plain(*args, finalize=fin)):
            assert torch.equal(g, w)
    t, c = torch.zeros((4, 24)), torch.zeros(4)
    fa.fedavg_accum_into(t, c, x, mm)
    assert (fa.fedavg_accum.launches, qa.quantized_accum.launches) == before


def test_plain_version_sums_client_blocks_in_the_kernels_order():
    """K=10: a block of 8 clients, then a block of 2.  Each block's sum
    starts from zero, so the last two ones add to 2 before they meet
    2^24; left to right each one would round away (ties to even)."""
    x = torch.zeros((10, 1, 1))
    x[0], x[8], x[9] = 2.0 ** 24, 1.0, 1.0
    m = torch.ones((10, 1))
    got, cnt = fa.fedavg_accum_plain(x, m, finalize=False)
    flat = torch.tensor(0.0)
    for k in range(10):
        flat = flat + x[k, 0, 0]
    assert got[0, 0] == 2.0 ** 24 + 2 and flat == 2.0 ** 24
    assert cnt[0] == 10


@pytest.mark.parametrize("bad", ["pk_dtype", "mask_dtype", "mask_shape",
                                 "strided", "device", "rank", "scales",
                                 "total_shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    pk, m = _inputs((3, 4, 8), True)
    x, mm = torch.from_numpy(pk), torch.from_numpy(m)
    q, s = torch.zeros((3, 4, 8), dtype=torch.int8), torch.ones((3, 4))
    with pytest.raises((TypeError, ValueError)):
        if bad == "pk_dtype":
            fa.fedavg_accum(x.double(), mm)
        elif bad == "mask_dtype":
            fa.fedavg_accum(x, mm.double())
        elif bad == "mask_shape":
            fa.fedavg_accum(x, mm[:, :3].contiguous())
        elif bad == "strided":
            fa.fedavg_accum(x.transpose(0, 1).contiguous().transpose(0, 1),
                            mm)
        elif bad == "device":
            fa.fedavg_accum(x.to("meta"), mm.to("meta"))
        elif bad == "rank":
            fa.fedavg_accum(x[0], mm)
        elif bad == "scales":
            qa.quantized_accum(q, s[:, :2].contiguous(), mm)
        else:
            fa.fedavg_accum_into(torch.zeros((4, 7)), torch.zeros(4), x, mm)
