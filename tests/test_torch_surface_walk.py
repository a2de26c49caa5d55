"""Every module of the JAX package against its counterpart in the port.

``pkgutil.walk_packages`` lists every module of ``atlite_tpu``; each has a
module of the same name in ``atlite_tpu_torch``, and each public function
and class defined there (its public methods, ``__init__`` and properties
included) has its counterpart with the same parameters: names, kinds and
defaults in order.  The port may add the parameters that say where it
runs (``PORT_ONLY``).  What the port leaves out on purpose is written out
below; nothing else may be missing.
"""

import importlib
import inspect
import pkgutil

import pytest

import atlite_tpu

# modules with no counterpart: the tests' float64 oracle, and the JAX
# package's build of its C++ geometry engine (the port builds its own)
INTENDED_MODULES = {
    "atlite_tpu.reference_impl": "the tests' float64 oracle, not a function of the system",
    "atlite_tpu.native.libatlite_geom": "the JAX package's built extension",
}
# public names with no counterpart
INTENDED_NAMES = {
    "atlite_tpu.ops.bsr_spmm.bsr_spmm_pallas": "the TPU kernel; the port's is bsr_spmm_kernel",
    "atlite_tpu.physics.csp.interp2d_regular": "one searchsorted and four gathers instead",
    "atlite_tpu.physics.csp.interp2d_uniform_hats": "one searchsorted and four gathers instead",
    "atlite_tpu.core.timeutil.to_datetimeindex": "returns pandas, which the port does not import",
}
# parameters the JAX function has and the port's leaves out: the TPU
# kernel's tiling, and the trace directory's default (the port's writes
# under its checkout)
INTENDED_PARAMS = {
    "atlite_tpu.ops.megakernel.wind_pv_bus_megakernel": {"time_tile", "cell_tile", "interpret"},
}
INTENDED_DEFAULTS = {"atlite_tpu.profiling.device_trace": {"logdir"}}
# parameters only the port has: where it runs
PORT_ONLY = {
    "atlite_tpu.convert.convert_line_rating": {"device"},
    "atlite_tpu.core.comm.global_mesh": {"devices"},
    "atlite_tpu.cutout.Cutout": {"device"},
    "atlite_tpu.cutout.Cutout.__init__": {"device"},
    "atlite_tpu.cutout.Cutout.availabilitymatrix": {"mesh"},
    "atlite_tpu.gis.exclusion.compute_availabilitymatrix": {"mesh"},
    "atlite_tpu.ops.bsr_spmm.stage_banded": {"device"},
    "atlite_tpu.ops.megakernel.wind_pv_bus_megakernel": {"table"},
    "atlite_tpu.physics.hydro.inflow_for_plants": {"device", "dtype"},
    "atlite_tpu.physics.hydro.shift_and_aggregate_runoff_for_plants": {"device"},
    "atlite_tpu.profiling.device_trace": {"device"},
    "atlite_tpu.utils.migrate_from_cutout_directory": {"device"},
}

MODULES = sorted(m.name for m in pkgutil.walk_packages(atlite_tpu.__path__, "atlite_tpu.")
                 if m.name not in INTENDED_MODULES)


def counterpart(name):
    return "atlite_tpu_torch" + name[len("atlite_tpu"):]


def public(module):
    """{qualified name: object} of the public functions and classes
    defined in ``module``, and of each class's public methods,
    ``__init__`` and properties."""
    out = {}
    for n, f in vars(module).items():
        if n.startswith("_") or getattr(f, "__module__", None) != module.__name__:
            continue
        if not (inspect.isclass(f) or callable(f)):
            continue
        out[f"{module.__name__}.{n}"] = f
        if inspect.isclass(f):
            for m, g in vars(f).items():
                g = g.__func__ if isinstance(g, (staticmethod, classmethod)) else g
                if (m == "__init__" or not m.startswith("_")) and (
                        inspect.isfunction(g) or isinstance(g, property)):
                    out[f"{module.__name__}.{n}.{m}"] = g
    return out


def lookup(module, qualname):
    """The port's object of a JAX qualified name, or None."""
    obj = module
    for part in qualname.split(".")[len(module.__name__.split(".")):]:
        obj = inspect.getattr_static(obj, part, None) if inspect.isclass(obj) else getattr(
            obj, part, None)
        if obj is None:
            return None
    return obj.__func__ if isinstance(obj, (staticmethod, classmethod)) else obj


def parameters(f):
    try:
        return inspect.signature(f).parameters.values()
    except (TypeError, ValueError):  # a builtin or a property
        return None


def test_the_walk_sees_every_module():
    assert "atlite_tpu.resource" in MODULES and "atlite_tpu.io.grib" in MODULES
    assert len(MODULES) >= 50
    assert set(INTENDED_NAMES) | set(INTENDED_PARAMS) | set(PORT_ONLY) <= {
        q for m in MODULES for q in public(importlib.import_module(m))}


@pytest.mark.parametrize("name", MODULES)
def test_module_has_its_counterpart(name):
    jax_module = importlib.import_module(name)
    port_module = importlib.import_module(counterpart(name))
    missing = {q for q in public(jax_module) if lookup(port_module, counterpart(q)) is None}
    assert missing == {q for q in INTENDED_NAMES if q.rsplit(".", 1)[0] == name}
    bad = {}
    for q, f in public(jax_module).items():
        g = lookup(port_module, counterpart(q))
        want, got = parameters(f), parameters(g) if g is not None else None
        if want is None or got is None:
            continue
        extra = PORT_ONLY.get(q, set())
        dropped = INTENDED_PARAMS.get(q, set())
        free = INTENDED_DEFAULTS.get(q, set())

        def key(p):
            return (p.name, p.kind, None if p.name in free else p.default)

        kept_got = [key(p) for p in got if p.name not in extra]
        kept_want = [key(p) for p in want if p.name not in dropped]
        if kept_got != kept_want or not extra <= {p.name for p in got}:
            bad[q] = (kept_want, kept_got)
    assert not bad
