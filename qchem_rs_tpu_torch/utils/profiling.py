"""Profiling hook (port of ``qchem_rs_tpu/utils/profiling.py``'s ``trace``):
a ``torch.profiler`` window around a run, written as a Chrome trace."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """Profile the enclosed block with ``torch.profiler`` (host activity,
    and the card's when CUDA is available) and write its Chrome trace to
    ``<trace_dir>/trace.<pid>.json``, making the directory; a no-op when
    ``trace_dir`` is None. Open the file in Perfetto or chrome://tracing."""
    if trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace.{os.getpid()}.json"))
