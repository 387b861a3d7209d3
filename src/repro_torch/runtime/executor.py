"""The unified ``Executor`` API: one front door to every runtime.  Port
of ``repro.runtime.executor``.

The strategy/IR layer is runtime-agnostic (the paper's core claim); what
varies is how a compiled ``GlobalPlan`` is *executed*.  Every launcher,
supervisor and benchmark selects a runtime through this registry, never
by comparing backend names:

  ``get_backend(name)``        resolve a backend (lazy import)
  ``list_backends()``          names, for --help and error messages
  ``make_executor(name, prog, params=..., physical_devices=...)``
                               compile a plan on a backend -> executor
  ``executor_factory(name)``   the ``ElasticSupervisor`` runner-factory
                               shape: ``(prog, params, devices) -> ex``
  ``@register_backend(name)``  add a backend (third-party runtimes too)

The port registers the JAX package's three builtins, in its order:
``reference`` (the interpreter: simulated devices, oracle numerics and
memory ledgers), ``spmd`` (one controller drives every rank, each on a
stream of its own) and ``mpmd`` (a controller thread per rank, each
running only its own program, over an asynchronous message transport).
The JAX package's trace-size counter (an equation count of a traced
program) has no counterpart here: the port's chunks run eagerly and
trace nothing, so the lanes count the operations of their programs.

Every backend implements the same protocol (``Executor``):

  ``compile(prog, params=None, *, physical_devices=None, **opts)``
      classmethod: validate the plan against this runtime and return a
      ready executor (the "handle").
  ``run(batch) -> RunResult``  one training step (loss + grads, the
      reference contract every backend is checked against)
  ``params``                   settable: swap weights (the
      elastic-resume contract)
  ``physical_devices``         the physical device indices the logical
      plan ranks landed on (simulated ranks for the interpreter)
  ``backend_name`` / ``capabilities``
      registry identity + honest feature flags (see
      ``BackendCapabilities``); capability flags — not backend-name
      string compares — are how callers branch on behavior.

Capabilities are declared HERE, in the builtin spec table, so callers
can consult them without importing a backend module.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable, Optional, Protocol, runtime_checkable

__all__ = [
    "BackendCapabilities", "BackendSpec", "Executor",
    "UnknownBackendError", "executor_factory", "get_backend",
    "get_backend_spec", "list_backends",
    "make_executor", "register_backend",
]


@dataclass(frozen=True)
class BackendCapabilities:
    """Honest feature flags per backend — what a caller may rely on.

    ``real_xla``        executes each logical rank on a real device of
                        its own (the name is the JAX package's; no port
                        backend sets it: the lanes place their ranks
                        round-robin, eight of them on one card);
    ``memory_ledgers``  ``RunResult.ledgers`` is populated (per-device
                        peak-memory accounting);
    ``measured_time``   ``measure(batch)`` returns meaningful wall-clock
                        step time for the compiled program;
    ``per_rank_trace``  each rank carries only its own traced program
                        (no whole-mesh trace on every device);
    ``multi_controller`` ranks are dispatched by independent controllers
                        over an async transport (MPMD dispatch model);
    ``elastic``         honors ``physical_devices`` rank->device mapping
                        (the elastic shrink/regrow resume path).
    """
    real_xla: bool = False
    memory_ledgers: bool = False
    measured_time: bool = False
    per_rank_trace: bool = False
    multi_controller: bool = False
    elastic: bool = True


@dataclass
class BackendSpec:
    """Registry entry: identity + capabilities + a lazy class locator
    (``module:Class``), so consulting the registry never imports a
    runtime module."""
    name: str
    locator: str                      # "package.module:ClassName"
    capabilities: BackendCapabilities
    summary: str = ""
    cls: Optional[type] = None        # resolved lazily / by decorator

    def load(self) -> type:
        if self.cls is None:
            mod_name, _, cls_name = self.locator.partition(":")
            self.cls = getattr(importlib.import_module(mod_name),
                               cls_name)
        return self.cls


class UnknownBackendError(ValueError):
    """Raised for a backend name the registry does not know; the message
    always lists the registered names."""


_REGISTRY: dict[str, BackendSpec] = {}


def _builtin(name: str, locator: str, caps: BackendCapabilities,
             summary: str) -> None:
    _REGISTRY[name] = BackendSpec(name, locator, caps, summary)


_builtin(
    "reference", "repro_torch.runtime.interpreter:Interpreter",
    BackendCapabilities(real_xla=False, memory_ledgers=True,
                        measured_time=False, per_rank_trace=False,
                        multi_controller=False, elastic=True),
    "oracle interpreter on simulated devices (numerics + memory ledgers)")
_builtin(
    "spmd", "repro_torch.runtime.spmd:SpmdExecutor",
    BackendCapabilities(real_xla=False, memory_ledgers=False,
                        measured_time=True, per_rank_trace=False,
                        multi_controller=False, elastic=True),
    "one controller drives every rank, a stream each (whole-mesh program)")
_builtin(
    "mpmd", "repro_torch.runtime.mpmd:MpmdExecutor",
    BackendCapabilities(real_xla=False, memory_ledgers=False,
                        measured_time=True, per_rank_trace=True,
                        multi_controller=True, elastic=True),
    "per-rank programs, multi-controller dispatch, async transport")


def register_backend(name: str,
                     capabilities: Optional[BackendCapabilities] = None,
                     summary: str = "") -> Callable[[type], type]:
    """Class decorator registering an ``Executor`` implementation.

    Builtin names bind the decorated class to their pre-declared spec
    (capabilities live in this module's table, the single source of
    truth); new names must supply ``capabilities``.  The decorator
    stamps ``backend_name`` and ``capabilities`` onto the class."""
    def deco(cls: type) -> type:
        spec = _REGISTRY.get(name)
        if spec is None:
            if capabilities is None:
                raise ValueError(
                    f"register_backend({name!r}) needs capabilities= "
                    "for a non-builtin backend")
            spec = BackendSpec(name, f"{cls.__module__}:{cls.__name__}",
                               capabilities, summary, cls=cls)
            _REGISTRY[name] = spec
        else:
            spec.cls = cls
        cls.backend_name = name
        cls.capabilities = spec.capabilities
        return cls
    return deco


def get_backend_spec(name: str) -> BackendSpec:
    """The registry entry for ``name`` (import-free: capabilities and
    summary are available without loading the backend class)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownBackendError(
            f"unknown backend {name!r}; registered backends: "
            f"{', '.join(list_backends())}") from None


def get_backend(name: str) -> type:
    """Resolve a backend name to its executor class (imports it)."""
    return get_backend_spec(name).load()


def list_backends() -> tuple[str, ...]:
    """Registered backend names, registration order."""
    return tuple(_REGISTRY)


def backends_help() -> str:
    """One line per backend — the --help / error-message rendering."""
    return "; ".join(f"'{s.name}': {s.summary}"
                     for s in _REGISTRY.values())


def make_executor(name: str, prog, params: Optional[dict] = None, *,
                  physical_devices: Optional[Any] = None, **opts):
    """Compile ``prog`` on backend ``name`` -> a ready executor handle.
    The single front door ``--backend``, ``ElasticSupervisor`` and the
    benchmarks select runtimes through."""
    return get_backend(name).compile(
        prog, params=params, physical_devices=physical_devices, **opts)


def executor_factory(name: str, **opts) -> Callable:
    """A runner factory in the ``ElasticSupervisor`` contract shape:
    ``factory(prog, params, physical_devices) -> executor``.  Resolves
    the backend lazily, at first build."""
    get_backend_spec(name)   # fail fast on unknown names

    def factory(prog, params, physical_devices):
        return make_executor(name, prog, params=params,
                             physical_devices=physical_devices, **opts)
    factory.backend_name = name
    return factory


@runtime_checkable
class Executor(Protocol):
    """Structural protocol every registered backend satisfies."""
    backend_name: str
    capabilities: BackendCapabilities
    params: Any
    physical_devices: Any

    @classmethod
    def compile(cls, prog, params: Optional[dict] = None, *,
                physical_devices: Optional[Any] = None,
                **opts) -> "Executor":
        ...

    def run(self, batch: dict[str, Any]):
        ...
