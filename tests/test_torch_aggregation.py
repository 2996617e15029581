"""The port's ``core/aggregation.py`` held against ``repro.core.aggregation``:
masked/approx/int8 aggregation, ``aggregate_flat`` in both backends
(port ``"plain"`` against JAX ``"jnp"``, port ``"kernel"`` against JAX
``"pallas"`` in interpret mode) and ``fused_round_step`` with the loss
masks and the conflict-thinning draw passed to both packages.

Bitwise on integer-valued flats and integer weights, where every f32 sum
is exact; rtol 1e-5 / atol 1e-6 elsewhere.  The int8 modes quantize with
``scale = absmax / 127`` in both packages, eagerly (the reference's
jitted training loop may round that scale otherwise: ROADMAP.md, faults),
so the int8 sums agree to rtol, not to bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.core.packets import depacketize as ref_depacketize
from repro.core.packets import packetize as ref_packetize
from repro_torch.core import aggregation as agg
from repro_torch.core.packets import (depacketize, loss_mask, packetize,
                                      straggler_mask)
from repro_torch.kernels import fedavg_accum as fa
from repro_torch.kernels import quantized_accum as qa

PAYLOAD = 367


def _round_inputs(seed, k=5, p=1000, payload=PAYLOAD, integer=False):
    rng = np.random.default_rng(seed)
    n = -(-p // payload)
    flats = (rng.integers(-8, 9, (k, p)) if integer
             else rng.normal(size=(k, p))).astype(np.float32)
    up = (rng.random((k, n)) > 0.3).astype(np.float32)
    down = (rng.random((k, n)) > 0.3).astype(np.float32)
    prev = (rng.integers(-8, 9, p) if integer
            else rng.normal(size=p)).astype(np.float32)
    wts = (rng.integers(1, 5, k) if integer
           else rng.random(k) + 0.5).astype(np.float32)
    return flats, up, down, prev, wts


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _check(got, want, exact):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want).reshape(got.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _survive(seed, shape, rate):
    """The reference's conflict-thinning draw, to hand to the port."""
    key = jax.random.PRNGKey(seed)
    return key, np.array(jax.random.bernoulli(key, 1.0 - rate, shape))


@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
@pytest.mark.parametrize("weighted", [True, False])
def test_masked_and_dequantize_aggregate_match_reference(integer, weighted):
    flats, up, _, _, wts = _round_inputs(1, integer=integer)
    pk = np.stack([np.asarray(ref_packetize(jnp.asarray(f), 50))
                   for f in flats])                       # (K, N, W)
    m = (np.random.default_rng(2).random(pk.shape[:2]) > 0.3).astype(
        np.float32)
    w = wts if weighted else None
    want = ref_agg.masked_aggregate(jnp.asarray(pk), jnp.asarray(m),
                                    None if w is None else jnp.asarray(w))
    got = agg.masked_aggregate(*_t(pk, m),
                               None if w is None else torch.from_numpy(w))
    for g, x in zip(got, want):
        _check(g, x, integer)
    q, s = ref_agg.quantize_packets(jnp.asarray(pk))
    qt, st = agg.quantize_packets(torch.from_numpy(pk))
    _check(qt, q, True)
    _check(st, s, True)
    want = ref_agg.dequantize_aggregate(q, s, jnp.asarray(m),
                                        None if w is None else jnp.asarray(w))
    got = agg.dequantize_aggregate(qt, st, torch.from_numpy(m),
                                   None if w is None else torch.from_numpy(w))
    for g, x in zip(got, want):
        _check(g, x, False)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
def test_approx_aggregate_with_the_reference_draw(rate, integer):
    flats, up, _, _, wts = _round_inputs(3, integer=integer)
    pk = np.asarray(jax.vmap(lambda f: ref_packetize(f, PAYLOAD))(
        jnp.asarray(flats)))
    key, survive = _survive(4, pk.shape, rate)
    want = ref_agg.approx_aggregate(jnp.asarray(pk), jnp.asarray(up), key,
                                    rate, jnp.asarray(wts))
    got = agg.approx_aggregate(*_t(pk, up), None, rate,
                               torch.from_numpy(wts),
                               survive=torch.from_numpy(survive))
    for g, x in zip(got, want):
        _check(g, x, integer)


def test_approx_aggregate_draws_from_a_generator():
    flats, up, _, _, wts = _round_inputs(5, integer=True)
    pk = packetize(torch.from_numpy(flats), PAYLOAD)
    up_t, w_t = torch.from_numpy(up), torch.from_numpy(wts)
    exact = agg.masked_aggregate(pk, up_t, w_t)
    none = agg.approx_aggregate(pk, up_t, None, 0.5, w_t)
    draws = [agg.approx_aggregate(pk, up_t,
                                  torch.Generator().manual_seed(7), 0.5, w_t)
             for _ in range(2)]
    assert torch.equal(none[0], exact[0])     # no generator: no thinning
    assert torch.equal(draws[0][0], draws[1][0])      # one seed, one draw
    assert not torch.equal(draws[0][0], exact[0])
    for _, counts in [none, *draws]:           # the divisor sees every
        assert torch.equal(counts, exact[1])   # received packet


def test_client_update_with_fallback_matches_reference():
    rng = np.random.default_rng(6)
    local = rng.normal(size=(4, 3, 8)).astype(np.float32)
    glob = rng.normal(size=(3, 8)).astype(np.float32)
    down = (rng.random((4, 3)) > 0.5).astype(np.float32)
    want = jax.vmap(ref_agg.client_update_with_fallback, (0, None, 0))(
        *_j(local, glob, down))
    got = agg.client_update_with_fallback(*_t(local, glob, down))
    _check(got, want, True)


# port backend -> the reference backend it stands for
BACKENDS = [("plain", "jnp"), ("kernel", "pallas")]


@pytest.mark.parametrize("backend,ref_backend", BACKENDS,
                         ids=[b for b, _ in BACKENDS])
@pytest.mark.parametrize("mode", ["exact", "int8", "approx"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
def test_aggregate_flat_matches_reference(backend, ref_backend, mode,
                                          integer):
    flats, up, _, _, wts = _round_inputs(7, integer=integer)
    K, N = up.shape
    key, survive = _survive(8, (K, N, PAYLOAD), 0.2)
    want = ref_agg.aggregate_flat(*_j(flats, up), PAYLOAD, mode=mode,
                                  conflict_rng=key, conflict_rate=0.2,
                                  weights=jnp.asarray(wts),
                                  backend=ref_backend)
    got = agg.aggregate_flat(*_t(flats, up), PAYLOAD, mode=mode,
                             conflict_rate=0.2, weights=torch.from_numpy(wts),
                             backend=backend,
                             survive=torch.from_numpy(survive))
    _check(got[0], want[0], integer and mode != "int8")
    _check(got[1], want[1], integer)


def test_aggregate_flat_kernel_backend_reaches_the_kernels():
    """On CPU tensors the "kernel" backend runs the kernels' plain
    versions, so it gives their bits; no launch is counted."""
    flats, up, _, _, wts = _round_inputs(9)
    f, u, w = _t(flats, up, wts)
    before = (fa.fedavg_accum.launches, qa.quantized_accum.launches)
    pk = packetize(f, PAYLOAD)
    got = agg.aggregate_flat(f, u, PAYLOAD, weights=w)
    want = fa.fedavg_accum_plain(pk, u * w[:, None])
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    got = agg.aggregate_flat(f, u, PAYLOAD, mode="int8", weights=w)
    q, s = agg.quantize_packets(pk)
    want = qa.quantized_accum_plain(q, s, u * w[:, None])
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert (fa.fedavg_accum.launches, qa.quantized_accum.launches) == before


@pytest.mark.parametrize("backend,ref_backend", BACKENDS,
                         ids=[b for b, _ in BACKENDS])
@pytest.mark.parametrize("mode", ["exact", "int8", "approx"])
@pytest.mark.parametrize("mix_alpha", [0.0, 0.25])
def test_fused_round_step_matches_reference(backend, ref_backend, mode,
                                            mix_alpha):
    flats, up, down, prev, wts = _round_inputs(10, integer=True)
    up[:, 1] = 0.0                       # a packet nobody delivered
    K, N = up.shape
    key, survive = _survive(11, (K, N, PAYLOAD), 0.2)
    want = ref_agg.fused_round_step(*_j(flats, up, down, prev), PAYLOAD,
                                    mode=mode, conflict_rng=key,
                                    conflict_rate=0.2,
                                    weights=jnp.asarray(wts),
                                    mix_alpha=mix_alpha,
                                    backend=ref_backend)
    got = agg.fused_round_step(*_t(flats, up, down, prev), PAYLOAD,
                               mode=mode, conflict_rate=0.2,
                               weights=torch.from_numpy(wts),
                               mix_alpha=mix_alpha, backend=backend,
                               survive=torch.from_numpy(survive))
    for g, x in zip(got, want):
        _check(g, x, mode != "int8")
    assert float(got[2][1]) == 0.0
    np.testing.assert_array_equal(got[1].numpy()[PAYLOAD:2 * PAYLOAD],
                                  prev[PAYLOAD:2 * PAYLOAD])


def test_fused_round_step_count_fallback_and_downlink():
    """Packets nobody uploaded keep the previous global; clients keep
    their local values where the downlink dropped the packet."""
    payload = 4
    flats, _, _, prev, _ = _round_inputs(0, k=3, p=12, payload=payload)
    up = np.ones((3, 3), np.float32)
    up[:, 1] = 0.0                                    # packet 1 lost
    down = np.ones((3, 3), np.float32)
    down[0, 2] = 0.0
    nf, ng, counts = agg.fused_round_step(*_t(flats, up, down, prev),
                                          payload)
    want = ref_agg.fused_round_step(*_j(flats, up, down, prev), payload)
    for g, x in zip((nf, ng, counts), want):
        _check(g, x, False)
    assert float(counts[1]) == 0.0
    assert torch.equal(ng[4:8], torch.from_numpy(prev[4:8]))
    assert torch.equal(nf[0, 8:12], torch.from_numpy(flats[0, 8:12]))
    assert torch.equal(nf[0, :8], ng[:8]) and torch.equal(nf[1], ng)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_round_step_matches_composed_path(seed):
    """The fused flat round equals the packetize / fallback / depacketize
    composition, bit for bit (the reference's own property)."""
    flats, up, down, prev, wts = _round_inputs(seed)
    f, u, d, p, w = _t(flats, up, down, prev, wts)
    K, P = f.shape
    for mode in ("exact", "int8"):
        nf, ng, counts = agg.fused_round_step(f, u, d, p, PAYLOAD, mode=mode,
                                              weights=w, mix_alpha=0.25)
        gpk, cnts = agg.aggregate_flat(f, u, PAYLOAD, mode=mode, weights=w)
        gpk = torch.where(cnts[:, None] > 0, gpk, packetize(p, PAYLOAD))
        recv = agg.client_update_with_fallback(
            packetize(f, PAYLOAD), gpk.expand(K, *gpk.shape), d)
        nf_old = 0.25 * f + 0.75 * depacketize(recv, P)
        assert torch.equal(ng, depacketize(gpk, P))
        assert torch.equal(nf, nf_old)
        assert torch.equal(counts, cnts)


def test_depacketize_matches_reference():
    flats = _round_inputs(12)[0]
    pk = packetize(torch.from_numpy(flats[0]), PAYLOAD)
    _check(depacketize(pk, flats.shape[1]),
           ref_depacketize(ref_packetize(jnp.asarray(flats[0]), PAYLOAD),
                           flats.shape[1]), True)


def test_unknown_mode_and_backend_raise():
    f, u = _t(*_round_inputs(13)[:2])
    with pytest.raises(ValueError):
        agg.aggregate_flat(f, u, PAYLOAD, mode="median")
    with pytest.raises(ValueError):
        agg.aggregate_flat(f, u, PAYLOAD, backend="pallas")


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_loss_and_straggler_masks(rate):
    g = torch.Generator().manual_seed(0)
    m = loss_mask(g, 64, 200, rate)
    s = straggler_mask(g, 4000, rate)
    assert m.shape == (64, 200) and s.shape == (4000,)
    assert m.dtype == s.dtype == torch.float32
    assert set(m.unique().tolist()) <= {0.0, 1.0}
    for x in (m, s):
        assert abs(float(x.mean()) - (1.0 - rate)) < 0.03
    again = loss_mask(torch.Generator().manual_seed(0), 64, 200, rate)
    assert torch.equal(m, again)


def test_int8_scales_follow_the_eager_reference():
    """The port divides by 127 as the eager reference does; under
    ``jax.jit`` (the reference's training loop) XLA may multiply by the
    reciprocal instead, which moves a scale by at most one ulp."""
    from repro.core.packets import quantize_payload as ref_quantize
    x = np.random.default_rng(14).normal(size=(10, 50, PAYLOAD)).astype(
        np.float32)
    q_eager, s_eager = ref_quantize(jnp.asarray(x))
    _, s_jit = jax.jit(ref_quantize)(jnp.asarray(x))
    q, s = agg.quantize_packets(torch.from_numpy(x))
    _check(q, q_eager, True)
    _check(s, s_eager, True)
    s_eager, s_jit = np.asarray(s_eager), np.asarray(s_jit)
    ulp = np.abs(np.nextafter(s_eager, np.inf) - s_eager)
    assert (np.abs(s_jit - s_eager) <= ulp).all()
