"""Device memory budgets (kpop_tpu/device.py): read from the device's own
limit, an error on an accelerator that reports none, unbudgeted on CPU."""

import numpy as np
import pytest

from kpop_tpu.device import memory_budget, memory_limit


class FakeDevice:
    platform = "gpu"
    device_kind = "fake accelerator"

    def __init__(self, stats):
        self.stats = stats

    def memory_stats(self):
        return self.stats


class FakeMesh:
    def __init__(self, dev):
        self.devices = np.array([dev])


def test_cpu_is_unbudgeted(monkeypatch):
    import jax

    monkeypatch.delenv("KPOP_TEST_BUDGET", raising=False)
    cpu = jax.devices("cpu")[0]
    assert memory_limit(cpu) is None
    assert memory_budget(cpu, "KPOP_TEST_BUDGET", 0.6) is None


def test_budget_from_bytes_limit(monkeypatch):
    monkeypatch.delenv("KPOP_TEST_BUDGET", raising=False)
    dev = FakeDevice({"bytes_limit": 1000, "bytes_in_use": 10})
    assert memory_limit(dev) == 1000
    assert memory_budget(dev, "KPOP_TEST_BUDGET", 0.5) == 500


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_accelerator_without_limit_is_an_error(stats, monkeypatch):
    monkeypatch.delenv("KPOP_TEST_BUDGET", raising=False)
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        memory_budget(FakeDevice(stats), "KPOP_TEST_BUDGET", 0.5)


def test_env_overrides_and_disables(monkeypatch, capsys):
    dev = FakeDevice({"bytes_limit": 1000})
    monkeypatch.setenv("KPOP_TEST_BUDGET", "1234")
    assert memory_budget(dev, "KPOP_TEST_BUDGET", 0.5) == 1234
    monkeypatch.setenv("KPOP_TEST_BUDGET", "0")
    assert memory_budget(dev, "KPOP_TEST_BUDGET", 0.5) is None
    monkeypatch.setenv("KPOP_TEST_BUDGET", "lots")
    assert memory_budget(dev, "KPOP_TEST_BUDGET", 0.5) == 500
    assert "unparseable" in capsys.readouterr().err


def test_ca_budget_is_sixty_percent_of_the_device(monkeypatch):
    from kpop_tpu.parallel.sharded import _hbm_budget

    monkeypatch.delenv("KPOP_CA_HBM_BYTES", raising=False)
    assert _hbm_budget(FakeMesh(FakeDevice({"bytes_limit": 1000}))) == 600
    with pytest.raises(RuntimeError):
        _hbm_budget(FakeMesh(FakeDevice(None)))


def test_no_params_budget_replicates():
    from kpop_tpu.parallel.serving import choose_kmer_parallel

    assert choose_kmer_parallel(10**12, 8, None) == 1
