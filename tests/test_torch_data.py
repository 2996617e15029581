"""The port's synthetic data and federated partitions against
``repro.data``: the same numpy draws, so one seed gives the same arrays
bit for bit."""
import numpy as np
import pytest
import torch

from repro.data import federated as ref_fed
from repro.data import synthetic as ref_syn
from repro_torch.data import federated, synthetic


def _both(seed, n, **kw):
    want = ref_syn.synthetic_image_classification(
        np.random.default_rng(seed), n, **kw)
    got = synthetic.synthetic_image_classification(
        np.random.default_rng(seed), n, **kw)
    return got, want


def _same(got, want):
    assert set(got) == set(want)
    for k in got:
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype


@pytest.mark.parametrize("kw", [{}, {"image_size": 8},
                                {"image_size": 4, "channels": 1,
                                 "num_classes": 3, "noise": 1.0,
                                 "task_seed": 7}], ids=str)
def test_synthetic_image_classification_is_bitwise(kw):
    _same(*_both(0, 50, **kw))


@pytest.mark.parametrize("n_clients,seed", [(4, 0), (3, 5), (10, 1)])
def test_partition_iid_is_bitwise(n_clients, seed):
    got, want = _both(seed, 103, image_size=4)
    parts = federated.partition_iid(got, n_clients, seed=seed)
    _same(parts, ref_fed.partition_iid(want, n_clients, seed=seed))
    assert parts["images"].shape[:2] == (n_clients, 103 // n_clients)


@pytest.mark.parametrize("alpha", [0.05, 0.3, 5.0])
@pytest.mark.parametrize("n_clients", [4, 9])
def test_partition_dirichlet_is_bitwise(alpha, n_clients):
    got, want = _both(2, 200, image_size=4)
    parts = federated.partition_dirichlet(got, n_clients, alpha=alpha,
                                          seed=3)
    _same(parts, ref_fed.partition_dirichlet(want, n_clients, alpha=alpha,
                                             seed=3))
    assert parts["labels"].shape == (n_clients, 200 // n_clients)
