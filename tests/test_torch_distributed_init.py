"""The port's process-group init ordering contract, as
tests/test_distributed_init.py holds JAX's: `init_distributed` is gated
on `torchrun`'s environment alone. Gated off, it neither initialises a
group nor touches CUDA; gated on, its first call into torch.distributed
or torch.cuda is the one that binds this rank's card, before any device
query, and the group it makes is the launcher's."""

import pytest
import torch
import torch.distributed as dist

from comat_tpu_torch.parallel import mesh

ENV = {"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "1",
       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29511"}


@pytest.fixture
def calls(monkeypatch):
    """Every call the function makes into torch.distributed and torch.cuda,
    in order; a device query raises."""
    seen = []

    def record(name, result=None):
        def f(*args, **kwargs):
            seen.append((name, args, kwargs))
            return result
        return f

    def forbidden(name):
        def f(*args, **kwargs):
            raise AssertionError(f"torch.cuda.{name}() before the process group")
        return f

    monkeypatch.setattr(dist, "init_process_group", record("init_process_group"))
    monkeypatch.setattr(dist, "is_initialized", record("is_initialized", False))
    monkeypatch.setattr(torch.cuda, "set_device", record("set_device"))
    for name in ("is_available", "device_count", "current_device", "get_device_name",
                 "init"):
        monkeypatch.setattr(torch.cuda, name, forbidden(name))
    return seen


def test_no_init_and_no_cuda_touch_when_gated_off(calls):
    assert mesh.init_distributed(environ={}) is False
    assert mesh.init_distributed(environ={"RANK": "0"}) is False
    assert calls == []


def test_nccl_on_the_local_card_when_gated_on(calls):
    assert mesh.init_distributed(environ=ENV) is True
    names = [c[0] for c in calls]
    assert names == ["is_initialized", "set_device", "init_process_group"]
    assert calls[1][1] == (torch.device("cuda", 1),)
    (backend,), kw = calls[2][1], calls[2][2]
    assert backend == "nccl" and kw["device_id"] == torch.device("cuda", 1)
    assert (kw["world_size"], kw["rank"]) == (4, 2)
    assert kw["init_method"] == "tcp://127.0.0.1:29511"
    assert kw["timeout"] >= mesh.TIMEOUT


def test_gloo_on_the_cpu_touches_no_cuda(calls):
    assert mesh.init_distributed(environ=ENV, device="cpu") is True
    assert [c[0] for c in calls] == ["is_initialized", "init_process_group"]
    assert calls[1][1] == ("gloo",) and "device_id" not in calls[1][2]


def test_a_held_group_is_kept(calls, monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert mesh.init_distributed(environ=ENV) is False
    assert calls == []
