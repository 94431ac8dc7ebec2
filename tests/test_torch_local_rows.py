"""The port's `parallel.mesh.local_rows` on the four cases that
tests/test_multichip_gsam.py holds JAX's `_local_rows` to: the rows of a
batch-sharded global array that one process's segmenter should see, in
global order, each row once across the model axis's replicas. In the
port each process is one rank of a (data, model) mesh; the meshes below
are made for each rank without a process group."""

import numpy as np
import torch

from comat_tpu_torch.parallel.mesh import Mesh, local_rows


def _ranks(data, model):
    return [Mesh(data * model, r, data, model) for r in range(data * model)]


def _gather(x, meshes):
    """Every data index's rows, from the ranks in the order given, placed
    by data index."""
    by_index = {}
    for m in meshes:
        by_index.setdefault(m.data_index, local_rows(x, m))
    return np.concatenate([by_index[i] for i in sorted(by_index)], axis=0)


def test_local_rows_global_order_dp_only():
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    meshes = _ranks(8, 1)
    assert [local_rows(x, m).shape[0] for m in meshes] == [2] * 8
    np.testing.assert_array_equal(_gather(x, meshes), x)


def test_local_rows_dedups_model_axis_replicas():
    """On a (4, 2) mesh every data block is held by two ranks (one a model
    index), which see the same rows: each row comes back once."""
    x = np.arange(8 * 2 * 2, dtype=np.float32).reshape(8, 2, 2)
    meshes = _ranks(4, 2)
    starts = sorted(int(local_rows(x, m)[0, 0, 0]) // 4 for m in meshes)
    assert starts == [0, 0, 2, 2, 4, 4, 6, 6]
    for a, b in zip(meshes[::2], meshes[1::2]):
        np.testing.assert_array_equal(local_rows(x, a), local_rows(x, b))
    np.testing.assert_array_equal(_gather(x, meshes), x)


def test_local_rows_shard_enumeration_order_independent():
    """Global order comes from the data index, not from the order the
    ranks are visited in."""
    x = torch.arange(4 * 5, dtype=torch.float32).reshape(4, 5)
    np.testing.assert_array_equal(_gather(x, list(reversed(_ranks(4, 2)))), x.numpy())


def test_local_rows_replicated_array_passthrough():
    """A mesh with one data index (the model axis only): every rank holds
    the whole batch."""
    x = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    for m in _ranks(1, 8):
        np.testing.assert_array_equal(local_rows(x, m), x)
