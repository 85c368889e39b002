"""The benchmark's spans around calls into the program's layers, for the
traced run only.  Each span synchronises the card before and after the
call, so that its host time is the layer's own and the device work inside
it is the call's; each also opens a `torch.profiler.record_function` of its
name, by which the trace reduction (`trace.py`) names what the host was
doing while the card idled and, for the calls whose device time a metric
reads, finds the device operations each call launched.  Nothing of the
program is edited: the wrappers replace attributes of the objects and
modules the frame loop calls through."""

from __future__ import annotations

import dataclasses
import time

import torch

PREFIX = "stokesbench."


@dataclasses.dataclass
class Span:
    name: str
    seconds: float
    info: dict | None


class Spans:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.records: list[Span] = []
        self.calls = 0
        self._undo = []

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def wrap(self, owner, attr, name, info=None, device_time=False):
        """Replace owner.attr by a spanned call; `info(args, kwargs, out)`
        gives what the span keeps of the call (shapes, counts).  With
        `device_time` each call's annotation is named `<name>#<call>` and
        the span keeps `info["call"]`, by which the trace reduction gives
        the device time of the operations this call launched
        (`trace.reduce`'s `span_device_s`)."""
        inner = getattr(owner, attr)
        label = PREFIX + name

        def spanned(*args, **kwargs):
            call = None
            if device_time:
                call = self.calls
                self.calls += 1
            self._sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(label if call is None else f"{label}#{call}"):
                out = inner(*args, **kwargs)
                self._sync()
            kept = info(args, kwargs, out) if info else None
            if call is not None:
                kept["call"] = call
            self.records.append(Span(name, time.perf_counter() - t0, kept))
            return out

        had = attr in vars(owner) if hasattr(owner, "__dict__") else True
        self._undo.append((owner, attr, inner, had))
        setattr(owner, attr, spanned)

    def restore(self):
        for owner, attr, inner, had in reversed(self._undo):
            if had:
                setattr(owner, attr, inner)
            else:
                delattr(owner, attr)
        self._undo.clear()

    def of(self, name):
        return [s for s in self.records if s.name == name]


def _node_sweep_info(args, kwargs, out):
    xi, Yj = args[0], args[1]
    return dict(
        kernel=kwargs.get("kernel", "free_space"),
        dtype=str(xi.dtype).replace("torch.", ""),
        nr=xi.shape[0],
        n=Yj.shape[0],
        m=Yj.shape[1],
    )


def _sweep_matvec_info(args, kwargs, out):
    st, _, XV, XK = args
    return dict(
        kernel=st.kernel,
        dtype=str(st.dtype).replace("torch.", ""),
        nr=st.nr,
        n=st.n,
        m=st.vmax * st.nq,
        shape=(1 if XV.ndim == 1 else XV.shape[1], 1 if XK.ndim == 1 else XK.shape[1]),
    )


def install(sim, cuda: bool) -> Spans:
    """Span the layers of a SwimmerSimulation `sim` that has run its
    warm-up (so that its matrix-free solver, if any, exists)."""
    import bemstokes_tpu_torch.matfree as matfree
    import bemstokes_tpu_torch.ops.assemble as assemble

    spans = Spans(cuda)
    prob = sim.problem
    spans.wrap(sim, "_save_frame", "files")
    spans.wrap(sim, "euler_for_frame", "geometry")
    spans.wrap(sim, "shape_velocities", "geometry")
    spans.wrap(prob, "_pipeline", "assembly")
    spans.wrap(prob.preconditioner, "maybe_refactor", "lu_factor", lambda a, k, out: dict(refactored=bool(out)))
    spans.wrap(prob, "_gmres_direct", "gmres", lambda a, k, out: dict(iterations=int(out[1]["iterations"])))
    if prob._matfree is not None:
        spans.wrap(prob._matfree, "_gmres", "matfree_gmres", lambda a, k, out: dict(iterations=int(out[1]["iterations"])))
    spans.wrap(assemble, "node_sweep", "bulk", _node_sweep_info, device_time=True)
    spans.wrap(matfree, "sweep_matvec", "matvec", _sweep_matvec_info, device_time=True)
    return spans
