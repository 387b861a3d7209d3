"""The port's unified Executor API (``repro_torch.runtime.executor``) with
its three builtin backends, on the CPU: the registry and protocol cases
of ``tests/test_executor_api.py``, the conformance run (one compiled plan
through every backend, the same loss), the absence of backend-name
string compares outside the registry, and the training CLI's
``--backend spmd`` and ``--backend mpmd`` each taking one step with the
loss of ``--backend reference``."""
import pathlib
import re

import pytest

from repro_torch import runtime
from repro_torch.runtime.executor import (BackendCapabilities, Executor, UnknownBackendError,
                                          backends_help, executor_factory, get_backend,
                                          get_backend_spec, list_backends, make_executor,
                                          register_backend)
from test_torch_spmd import small_prog

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_builtin_backends_registered():
    assert list_backends() == ("reference", "spmd", "mpmd")
    ref, spmd, mpmd = (get_backend_spec(n).capabilities for n in list_backends())
    assert isinstance(ref, BackendCapabilities)
    assert ref.memory_ledgers and not ref.measured_time
    assert spmd.measured_time and not spmd.per_rank_trace and not spmd.multi_controller
    assert mpmd.measured_time and mpmd.per_rank_trace and mpmd.multi_controller
    # no rank of a port backend has a real device of its own
    assert not any(c.real_xla for c in (ref, spmd, mpmd))


def test_unknown_backend_lists_registered_names():
    for call in (lambda: get_backend("smpd"), lambda: executor_factory("smpd")):
        with pytest.raises(UnknownBackendError) as ei:
            call()
        msg = str(ei.value)
        assert "smpd" in msg
        for name in list_backends():
            assert name in msg, (name, msg)


def test_backends_help_mentions_every_backend():
    text = backends_help()
    for name in list_backends():
        assert f"'{name}'" in text, (name, text)


def test_register_backend_third_party_roundtrip():
    from repro_torch.runtime import executor as ex_mod
    with pytest.raises(ValueError, match="capabilities"):
        register_backend("thirdparty")(type("X", (), {}))
    caps = BackendCapabilities(real_xla=False)
    try:
        @register_backend("thirdparty", capabilities=caps, summary="test stub")
        class Stub:
            @classmethod
            def compile(cls, prog, params=None, *, physical_devices=None, **opts):
                return cls()

        assert Stub.backend_name == "thirdparty"
        assert Stub.capabilities is caps
        assert get_backend("thirdparty") is Stub
    finally:
        ex_mod._REGISTRY.pop("thirdparty", None)


@pytest.mark.parametrize("name", ["reference", "spmd", "mpmd"])
def test_executor_factory_shape(name):
    """``executor_factory`` gives the ``ElasticSupervisor`` runner-factory
    shape, ``factory(prog, params, physical_devices)``, for each backend."""
    prog, batch = small_prog("1f1b")
    factory = executor_factory(name)
    assert factory.backend_name == name
    runner = factory(prog, prog.params, None)
    assert isinstance(runner, Executor)
    out = runner.run(batch)
    assert out.loss == pytest.approx(out.loss)   # finite, no NaN
    runner.params = prog.params                   # the elastic-resume contract
    assert runner.params is prog.params
    getattr(runner, "close", lambda: None)()


def test_protocol_surface_all_backends():
    for name in list_backends():
        cls = get_backend(name)
        assert cls.backend_name == name
        assert cls.capabilities is get_backend_spec(name).capabilities
        assert callable(getattr(cls, "compile")) and callable(getattr(cls, "run"))


def test_protocol_conformance_runs_all_backends():
    """One ``make_executor`` front door builds all three backends on one
    compiled plan; each satisfies the protocol and gives the same loss,
    bit for bit."""
    prog, batch = small_prog("1f1b")
    losses = {}
    for name in list_backends():
        ex = make_executor(name, prog, params=prog.params)
        assert isinstance(ex, Executor) and ex.backend_name == name
        assert len(ex.physical_devices) == 4, (name, ex.physical_devices)
        out = ex.run(batch)
        assert sorted(out.grads), name
        losses[name] = out.loss.hex()
        getattr(ex, "close", lambda: None)()
    assert len(set(losses.values())) == 1, losses


def test_no_string_backend_dispatch_outside_registry():
    offenders = []
    for p in (ROOT / "src" / "repro_torch").rglob("*.py"):
        if p.name == "executor.py":
            continue
        text = p.read_text()
        for needle in ('backend == "spmd"', "backend == 'spmd'", 'backend == "mpmd"',
                       "backend == 'mpmd'", 'backend == "reference"'):
            if needle in text:
                offenders.append((str(p), needle))
    assert not offenders, offenders


def _strategy_file(tmp_path):
    from repro_torch import core
    strat = core.Strategy(core.Mesh(pp=2, dp=2), core.Pipeline("1f1b", n_mb=4)
                          | core.ZeRO(stage=3))
    f = tmp_path / "strategy.json"
    f.write_text(strat.to_json())
    return f


def test_cli_backend_spmd_and_mpmd_take_the_reference_step(tmp_path, capsys):
    from repro_torch.launch import train
    f = _strategy_file(tmp_path)
    losses = {}
    for name in list_backends():
        rc = train.main(["--device", "cpu", "--d-model", "64", "--layers", "2",
                         "--vocab", "128", "--arch", "qwen3-1b", "--ckpt-dir",
                         str(tmp_path / name), "--strategy", str(f), "--backend", name])
        out = capsys.readouterr().out
        assert rc == 0, out
        losses[name] = re.search(rf"backend\[{name}\] loss=(\S+)", out).group(1)
    assert losses["spmd"] == losses["mpmd"] == losses["reference"], losses


def test_cli_unknown_backend_lists_names(capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as ei:
        train.main(["--backend", "smpd"])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    for name in list_backends():
        assert name in err, (name, err)
    assert runtime.list_backends() == list_backends()
