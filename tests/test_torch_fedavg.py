"""The port's FedAvg training loop (``core/fedavg.py::run_fedavg``) on the
CPU, at tests/test_fedavg.py's size (8x8 images, channels 8/16/16/16,
K=4 clients, 6 rounds), held to the JAX package's run.

- The reference's own behaviours, mirrored: exact converges, approx and
  int8 stay close to exact, 5% loss on both links is tolerated, client
  fraction, weighting and APFL mixing run.
- A twin run with every random draw taken out (dropout 0, one batch per
  client, the reference's initial parameters carried across): the
  per-round test losses match the JAX run to rtol 1e-4 (the conv
  algorithms differ), and the accuracies to one test sample.
- The full run, with its own draws: the final ``test_acc`` lies within
  0.1 of the JAX run's on the same data.  Band: at 256 training samples
  the final accuracy spreads by up to 0.31 between seeds of either
  package (seeds 0-3, shared initial parameters), so the band is taken
  at 1,024 samples, where JAX seeds 0-2 and 12 port runs (4 seeds for
  each JAX initialisation) all reached 1.0.  The sweep behind those
  numbers: ``PYTHONPATH=src python tests/test_torch_fedavg.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core import fedavg as ref_fedavg
from repro.data.federated import partition_iid as ref_partition_iid
from repro.data.synthetic import synthetic_image_classification as ref_syn
from repro.models import cnn as ref_cnn
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.fedavg import FedAvgConfig, ModelFns, run_fedavg
from repro_torch.data.federated import partition_iid
from repro_torch.data.synthetic import synthetic_image_classification
from repro_torch.kernels import fedavg_accum as fa
from repro_torch.kernels import quantized_accum as qa
from repro_torch.models import cnn

SMALL = dict(image_size=8, conv_channels=(8, 16, 16, 16), fc_hidden=32)
CNN = CNNConfig(**SMALL)
BAND = 0.1


def _model_fns(cfg=CNN, init=None):
    return ModelFns(
        init=init or (lambda g: cnn.init_cnn(g, cfg)),
        loss=lambda p, b, g: cnn.cnn_loss(p, b, cfg, dropout_rng=g),
        test_metrics=lambda p, d: {
            "test_loss": cnn.cnn_loss(p, d, cfg, train=False),
            "test_acc": cnn.cnn_accuracy(p, d, cfg),
        },
    )


def _ref_model_fns(cfg):
    return ref_fedavg.ModelFns(
        init=lambda rng: ref_cnn.init_cnn(rng, cfg),
        loss=lambda p, b, rng: ref_cnn.cnn_loss(p, b, cfg, dropout_rng=rng),
        test_metrics=lambda p, d: {
            "test_loss": ref_cnn.cnn_loss(p, d, cfg, train=False),
            "test_acc": ref_cnn.cnn_accuracy(p, d, cfg),
        },
    )


def _data(n_clients=4, n=256, seed=0):
    rng = np.random.default_rng(seed)
    train = synthetic_image_classification(rng, n, image_size=8)
    test = synthetic_image_classification(rng, 128, image_size=8)
    return partition_iid(train, n_clients, seed=seed), test


def _ref_data(n_clients=4, n=256, seed=0):
    rng = np.random.default_rng(seed)
    train = ref_syn(rng, n, image_size=8)
    test = ref_syn(rng, 128, image_size=8)
    return ref_partition_iid(train, n_clients, seed=seed), test


def _reference_init(seed, ref_cfg):
    """The reference run's initial parameters (run_fedavg's init key),
    carried across as a port ``ModelFns.init``."""
    init_rng = jax.random.split(jax.random.PRNGKey(seed))[1]
    p0 = jax.tree_util.tree_map(np.asarray,
                                ref_cnn.init_cnn(init_rng, ref_cfg))
    return lambda g: cnn.params_from_reference(p0, g.device)


@pytest.fixture(scope="module")
def histories():
    client_data, test = _data()
    out = {}
    for mode, extra in [
        ("exact", {}),
        ("approx", {"conflict_rate": 0.01}),
        ("int8", {}),
        ("loss", {"uplink_loss": 0.05, "downlink_loss": 0.05}),
    ]:
        cfg = FedAvgConfig(n_clients=4, rounds=6, local_epochs=1,
                           batch_size=32, lr=0.05,
                           agg_mode=mode if mode != "loss" else "exact",
                           **extra)
        out[mode] = run_fedavg(_model_fns(), client_data, test, cfg,
                               device="cpu")
    return out


def test_exact_converges(histories):
    h = histories["exact"]["test_loss"]
    assert h[-1] < h[0], h
    assert histories["exact"]["test_acc"][-1] > 0.5


def test_approx_close_to_exact(histories):
    """Paper Fig. 8: the approximated server ~= exact convergence."""
    exact = histories["exact"]["test_loss"][-1]
    approx = histories["approx"]["test_loss"][-1]
    assert approx < histories["approx"]["test_loss"][0]
    assert abs(approx - exact) < 0.5 * max(exact, 0.1) + 0.25


def test_int8_close_to_exact(histories):
    exact = histories["exact"]["test_loss"][-1]
    q = histories["int8"]["test_loss"][-1]
    assert abs(q - exact) < 0.5 * max(exact, 0.1) + 0.25


def test_packet_loss_tolerated(histories):
    h = histories["loss"]["test_loss"]
    assert h[-1] < h[0], h


def test_history_records_every_round(histories):
    for h in histories.values():
        for key in ("round", "test_loss", "test_acc", "train_s", "agg_s",
                    "peak_mem_bytes"):
            assert len(h[key]) == 6, key
        assert np.isfinite(h["test_loss"]).all()


def test_client_fraction_weighting_and_callback():
    client_data, test = _data(n_clients=4, n=256, seed=1)
    cfg = FedAvgConfig(n_clients=4, rounds=3, client_fraction=0.5,
                       batch_size=32, lr=0.05, weighted=True)
    before = (fa.fedavg_accum.launches, qa.quantized_accum.launches)
    h = run_fedavg(_model_fns(), client_data, test, cfg, device="cpu")
    assert len(h["test_loss"]) == 3 and h["round"] == [0, 1, 2]
    assert np.isfinite(h["test_loss"]).all()
    # no device memory to read on the CPU
    assert np.isnan(h["peak_mem_bytes"]).all()
    # on the CPU the server step runs the kernels' plain versions
    assert (fa.fedavg_accum.launches, qa.quantized_accum.launches) == before


def test_apfl_mixing_runs():
    client_data, test = _data(n_clients=2, n=128, seed=2)
    cfg = FedAvgConfig(n_clients=2, rounds=2, batch_size=32, mix_alpha=0.25)
    h = run_fedavg(_model_fns(), client_data, test, cfg, device="cpu")
    assert np.isfinite(h["test_loss"]).all()


def test_one_seed_gives_one_run():
    client_data, test = _data(n_clients=2, n=128, seed=3)
    cfg = FedAvgConfig(n_clients=2, rounds=2, batch_size=32,
                       agg_mode="approx", conflict_rate=0.1,
                       uplink_loss=0.1, downlink_loss=0.1, seed=4)
    runs = [run_fedavg(_model_fns(), client_data, test, cfg, device="cpu")
            for _ in range(2)]
    assert runs[0]["test_loss"] == runs[1]["test_loss"]


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    client_data, test = _data(n_clients=2, n=64)
    with pytest.raises(RuntimeError):
        run_fedavg(_model_fns(), client_data, test, FedAvgConfig(rounds=1))


@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_twin_run_without_draws_matches_reference(mode):
    """Dropout 0, one batch of the whole shard per client, full
    participation, no loss: nothing random is left but the initial
    parameters, which are carried across."""
    kw = {**SMALL, "dropout": 0.0}
    ref_cfg, cfg = RefCNNConfig(**kw), CNNConfig(**kw)
    run_kw = dict(n_clients=4, rounds=6, batch_size=64, lr=0.1,
                  agg_mode=mode, seed=0)
    ref_cd, ref_test = _ref_data()
    want = ref_fedavg.run_fedavg(_ref_model_fns(ref_cfg), ref_cd, ref_test,
                                 ref_fedavg.FedAvgConfig(**run_kw))
    client_data, test = _data()
    got = run_fedavg(_model_fns(cfg, _reference_init(0, ref_cfg)),
                     client_data, test, FedAvgConfig(**run_kw), device="cpu")
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=1e-4)
    # to one of the 128 test samples: a near-tie in the logits may flip
    np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                               atol=1 / 128)


def test_final_accuracy_within_band_of_reference():
    ref_cfg = RefCNNConfig(**SMALL)
    run_kw = dict(n_clients=4, rounds=6, batch_size=32, lr=0.05, seed=0)
    ref_cd, ref_test = _ref_data(n=1024)
    want = ref_fedavg.run_fedavg(_ref_model_fns(ref_cfg), ref_cd, ref_test,
                                 ref_fedavg.FedAvgConfig(**run_kw))
    client_data, test = _data(n=1024)
    got = run_fedavg(_model_fns(CNN, _reference_init(0, ref_cfg)),
                     client_data, test, FedAvgConfig(**run_kw), device="cpu")
    assert abs(got["test_acc"][-1] - want["test_acc"][-1]) <= BAND, (
        got["test_acc"], want["test_acc"])


def band_sweep(n_train, ref_seeds=(0, 1, 2), port_seeds=(0, 1, 2, 3)):
    """Final test_acc of the JAX run for each seed, and of the port's
    runs (each of ``port_seeds``) from that run's initial parameters."""
    ref_cfg = RefCNNConfig(**SMALL)
    ref_cd, ref_test = _ref_data(n=n_train)
    client_data, test = _data(n=n_train)
    for seed in ref_seeds:
        run_kw = dict(n_clients=4, rounds=6, batch_size=32, lr=0.05)
        want = ref_fedavg.run_fedavg(
            _ref_model_fns(ref_cfg), ref_cd, ref_test,
            ref_fedavg.FedAvgConfig(seed=seed, **run_kw))["test_acc"][-1]
        got = [run_fedavg(_model_fns(CNN, _reference_init(seed, ref_cfg)),
                          client_data, test, FedAvgConfig(seed=s, **run_kw),
                          device="cpu")["test_acc"][-1] for s in port_seeds]
        print(f"n={n_train} seed={seed}: jax {want:.4f} port "
              + " ".join(f"{a:.4f}" for a in got), flush=True)


if __name__ == "__main__":
    band_sweep(256, ref_seeds=(0, 1, 2, 3))
    band_sweep(1024)
