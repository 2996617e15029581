"""The port's paper CNN on parameters carried across from the JAX
package's ``init_cnn``: forward logits, loss, ``torch.autograd``
gradients against ``jax.grad``, one SGD step, and the flat parameter
vector the server aggregates.

rtol 1e-4 (atol 1e-5 for values near zero) on logits, losses and
gradients: the two packages convolve with different algorithms, which
sum the products in other orders.  Dropout runs with the reference's own
keep mask handed to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core.packets import flatten_pytree
from repro.models import cnn as ref_cnn
from repro_torch.configs.paper_cnn import CNNConfig, n_params
from repro_torch.core.packets import flatten_params
from repro_torch.models import cnn

SMALL = dict(image_size=8, conv_channels=(8, 16, 16, 16), fc_hidden=32)
TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(seed=0, batch=6, **cfg_kw):
    kw = {**SMALL, **cfg_kw}
    ref_cfg, cfg = RefCNNConfig(**kw), CNNConfig(**kw)
    params = ref_cnn.init_cnn(jax.random.PRNGKey(seed), ref_cfg)
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, cfg.image_size, cfg.image_size,
                              cfg.in_channels)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, batch).astype(np.int32)
    ref_batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    batch_t = {"images": torch.from_numpy(images),
               "labels": torch.from_numpy(labels)}
    return ref_cfg, cfg, params, cnn.params_from_reference(params), \
        ref_batch, batch_t


def _leaves_close(got, want):
    for layer in want:
        for name in want[layer]:
            np.testing.assert_allclose(got[layer][name].detach().numpy(),
                                       np.asarray(want[layer][name]), **TOL)


def test_params_layout_and_flat_vector_match_the_reference():
    ref_cfg, cfg, params, p, _, _ = _setup()
    flat_ref, _ = flatten_pytree(params)
    flat = flatten_params(p)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_ref))
    mine = cnn.init_cnn(torch.Generator().manual_seed(0), cfg)
    for layer in params:
        for name in params[layer]:
            assert tuple(mine[layer][name].shape) == \
                params[layer][name].shape
    assert flatten_params(mine).shape == (n_params(cfg),)


def test_paper_width_parameter_count():
    mine = cnn.init_cnn(torch.Generator().manual_seed(0), CNNConfig())
    assert flatten_params(mine).shape == (4_585_546,)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_logits_match(seed):
    ref_cfg, cfg, params, p, rb, b = _setup(seed)
    want = ref_cnn.cnn_forward(params, rb["images"], ref_cfg)
    got = cnn.cnn_forward(p, b["images"], cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paper_width_forward_matches():
    ref_cfg, cfg, params, p, rb, b = _setup(3, batch=2, **{
        "image_size": 32, "conv_channels": (32, 64, 128, 256),
        "fc_hidden": 256})
    want = ref_cnn.cnn_forward(params, rb["images"], ref_cfg)
    got = cnn.cnn_forward(p, b["images"], cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dropout", [False, True])
def test_loss_gradients_and_one_sgd_step_match(dropout):
    ref_cfg, cfg, params, p, rb, b = _setup(2)
    rng = jax.random.PRNGKey(5) if dropout else None
    keep = None
    if dropout:
        # the reference's draw inside cnn_forward, handed to the port
        keep = torch.from_numpy(np.array(jax.random.bernoulli(
            rng, 1.0 - cfg.dropout, (b["images"].shape[0], cfg.fc_hidden))))
    loss_ref, grads_ref = jax.value_and_grad(ref_cnn.cnn_loss)(
        params, rb, ref_cfg, dropout_rng=rng)
    leaves = [p[layer][name].requires_grad_(True)
              for layer in sorted(p) for name in sorted(p[layer])]
    loss = cnn.cnn_loss(p, b, cfg, keep_mask=keep)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(loss_ref), **TOL)
    g = {layer: {} for layer in p}
    it = iter(grads)
    for layer in sorted(p):
        for name in sorted(p[layer]):
            g[layer][name] = next(it)
    _leaves_close(g, grads_ref)
    lr = 0.05
    stepped_ref = jax.tree_util.tree_map(lambda w, gw: w - lr * gw,
                                         params, grads_ref)
    stepped = {layer: {n: (p[layer][n] - lr * g[layer][n]).detach()
                       for n in p[layer]} for layer in p}
    _leaves_close(stepped, stepped_ref)


def test_eval_loss_and_accuracy_match():
    ref_cfg, cfg, params, p, rb, b = _setup(4, batch=32)
    want = ref_cnn.cnn_loss(params, rb, ref_cfg, train=False)
    np.testing.assert_allclose(
        cnn.cnn_loss(p, b, cfg, train=False).item(), float(want), **TOL)
    assert cnn.cnn_accuracy(p, b, cfg).item() == \
        float(ref_cnn.cnn_accuracy(params, rb, ref_cfg))


def test_dropout_draws_from_a_generator_only_in_training():
    _, cfg, _, p, _, b = _setup(6)
    base = cnn.cnn_forward(p, b["images"], cfg)
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    on = [cnn.cnn_forward(p, b["images"], cfg, dropout_rng=g, train=True)
          for g in (g1, g2)]
    off = cnn.cnn_forward(p, b["images"], cfg, dropout_rng=g1, train=False)
    assert torch.equal(on[0], on[1]) and not torch.equal(on[0], base)
    assert torch.equal(off, base)
