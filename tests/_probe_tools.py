"""The JAX package's TPU probes (``tools/probe_*.py``) run on the CPU and
observed, for the tests that hold the card's probes to them.

``load_tool`` imports a tool as it is and replaces its module globals
``pl`` and ``jax`` with shims.  The shim's ``pallas_call`` runs in
interpret mode and wraps the tool's kernel: before the body runs, the
scratch arrays named by ``seeds`` are filled from extra inputs (interpret
mode leaves the others at zero); after it, every scratch array is copied
into an extra output.  The shim's ``jit`` records the first result of each
compiled function, and hands the tool only the output it asked for.
"""

from __future__ import annotations

import importlib.util
import itertools
import pathlib

import numpy as np

import jax
from jax.experimental import pallas as pl

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _observed(kernel, seeds: dict, *, out_shape, in_specs, out_specs,
              scratch_shapes=(), **kw):
    """``pl.pallas_call`` in interpret mode, with ``seeds`` ({scratch index:
    flat array}) loaded into the scratch first and every scratch array
    returned after the tool's output.  The call carries ``kept``, the
    scratch indices of those extra outputs."""
    scratch = list(scratch_shapes)
    kept = [k for k, s in enumerate(scratch) if hasattr(s, "shape")]
    init = {k: np.asarray(a).reshape(scratch[k].shape)
            for k, a in seeds.items()}
    nin, ns, nk = len(in_specs), len(init), len(kept)

    def body(*refs):
        ins, loads, o = refs[:nin], refs[nin:nin + ns], refs[nin + ns]
        finals = refs[nin + ns + 1:nin + ns + 1 + nk]
        scr = refs[nin + ns + 1 + nk:]
        for k, r in zip(init, loads):
            scr[k][...] = r[...]
        kernel(*ins, o, *scr)
        for k, r in zip(kept, finals):
            r[...] = scr[k][...]

    anywhere = pl.BlockSpec(memory_space=pl.ANY)
    f = pl.pallas_call(
        body,
        out_shape=(out_shape, *[jax.ShapeDtypeStruct(scratch[k].shape,
                                                     scratch[k].dtype)
                                for k in kept]),
        in_specs=[*in_specs, *[anywhere] * ns],
        out_specs=(out_specs, *[anywhere] * nk),
        scratch_shapes=scratch, interpret=True, **kw)
    extra = [jax.numpy.asarray(a) for a in init.values()]

    def call(*args):
        return f(*args, *extra)

    call.kept = kept
    return call


def load_tool(name: str, seeds=lambda k: {}):
    """tools/<name>.py with the observing shims.  ``seeds(k)`` gives the
    k-th ``pallas_call`` the tool makes (in its order) its {scratch index:
    flat array}.  Returns (the module, the results): results[k] is (word 0
    of call k's first run, {scratch index: its final contents})."""
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    results, made = [], itertools.count()

    class Pallas:
        def __getattr__(self, k):
            return getattr(pl, k)

        def pallas_call(self, kernel, **kw):
            return _observed(kernel, seeds(next(made)), **kw)

    class Jax:
        def __getattr__(self, k):
            return getattr(jax, k)

        def jit(self, f):
            g, seen = jax.jit(f), []

            def call(*args):
                out, *finals = g(*args)
                if not seen:
                    seen.append(True)
                    results.append((
                        int(np.asarray(out).reshape(-1)[0]),
                        {k: np.asarray(a).reshape(-1)
                         for k, a in zip(f.kept, finals)}))
                return out
            return call

    mod.pl, mod.jax = Pallas(), Jax()
    return mod, results
