"""Tracing / profiling utilities (own copy of
gcn_song_embeddings_tpu/utils/profiling.py, on PyTorch).

  * ``Timer`` -- named phase timing that records into a dict (the
    ``t (train)/t (emb)/t (knn)`` table columns): on the host clock, or,
    when the phase is given a CUDA tensor to wait for, with CUDA events
    on that tensor's device.
  * ``device_profile`` -- a ``torch.profiler`` trace of the CPU and, where
    there is one, the GPU, written under ``log_dir`` as a Chrome trace.
  * ``throughput`` -- units/s counters for the benchmark metrics.
  * ``MetricsLogger`` -- JSON lines under the reference's wandb field
    names, mirrored to ``wandb`` where that package is importable.

``sync`` waits for a value's device work: ``torch.cuda.synchronize`` on
the device of each CUDA tensor in it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Iterator

import torch


def _tensors(x: Any) -> list[torch.Tensor]:
    """The tensors in ``x``: a tensor, or lists, tuples and dict values of
    them, nested."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _cuda_device(x: Any) -> torch.device | None:
    return next((t.device for t in _tensors(x) if t.is_cuda), None)


def sync(x: Any) -> None:
    """Wait for the device work behind ``x`` (a tensor or a nest of them):
    ``torch.cuda.synchronize`` on each CUDA device it lives on; CPU
    tensors are ready as they are."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating named phase timer.

    >>> t = Timer()
    >>> with t.phase("train"): ...
    >>> t.times["train"]
    """

    def __init__(self) -> None:
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_value: Any = None) -> Iterator[None]:
        """Time the block, in seconds.  With a CUDA tensor in
        ``sync_value`` the phase is timed with CUDA events on its device's
        current stream (the device time from the block's first launch to
        its last), after waiting for them; otherwise on the host clock,
        after ``sync(sync_value)``."""
        dev = _cuda_device(sync_value)
        if dev is not None:
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        t0 = time.time()
        try:
            yield
        finally:
            if dev is not None:
                end.record(stream)
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                if sync_value is not None:
                    sync(sync_value)
                seconds = time.time() - t0
            self.times[name] = self.times.get(name, 0.0) + seconds

    def to_json(self) -> str:
        return json.dumps(self.times, sort_keys=True)


@contextlib.contextmanager
def device_profile(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` trace of the block (the CPU, and CUDA where a
    device is present), written to ``log_dir/trace_<pid>_<ns>.json``
    (Chrome trace format; open it in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` sum the trace by
    kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def throughput(n_units: float, seconds: float, unit: str = "edges"
               ) -> dict[str, float | str]:
    return {"value": n_units / max(seconds, 1e-12), "unit": f"{unit}/s",
            "seconds": seconds}


class MetricsLogger:
    """JSON-lines metrics sink with the reference's wandb field names
    (pinsage_training.py:241-246); if the ``wandb`` package is importable
    and WANDB_MODE is configured, mirrors every row there too."""

    def __init__(self, path: str, wandb_project: str | None = None,
                 run_name: str | None = None):
        self.path = path
        self._wandb = None
        if wandb_project is not None:
            try:
                import wandb  # optional

                wandb.init(project=wandb_project, name=run_name)
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log(self, row: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._wandb is not None:
            self._wandb.log(row)
