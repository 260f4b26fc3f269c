"""Set-up, warm-up and the timed window of one cell: the port's pipelined
schedule (``gaus_slam_tpu_torch/scripts/gaus_mp.py::rgbd_slam``'s turn)
driven from the benchmark's own frames.

Each turn hands one frame from the port's feeder thread (``datafeeder``:
``pack_frame``, pinned memory, its copy stream, backpressure at 5 frames)
to ``Frontend.process_frame``, merges a cut submap with
``Backend.process_localmap``, and runs up to four ``Backend.process``
calls; where the feeder has no frame ready the backend refines at random
and the turn sleeps the profile's ``sleep_time``, as the driver does. The
loop is closed: the feeder always runs ahead, as when a recorded
sequence is processed offline. The driver's dashboards, checkpoints,
final refinement and evaluation are not part of the window.

Set-up builds Frontend and Backend as ``scripts/gaus.py::start_run``
does, and runs the first two submap cuts (the first uses the merge
programs, the second the covisibility path) and their backend work.
After ``seconds`` no further frame is handed over, and the window ends
when the backend's task queue is empty and the card has finished.

With ``trace`` each frontend and backend call is fenced by a device
synchronisation and timed, and torch.profiler records the window.
"""
from __future__ import annotations

import contextlib
import copy
import queue
import threading
import time

import numpy as np
import torch

from .frames import FrameStream

# frames the feeder may run through: more than any window holds
N_FRAMES = 1 << 30
WARMUP_CUTS = 2


def _captures() -> int:
    from gaus_slam_tpu_torch.slam import programs

    return int(sum(programs.CAPTURES.values()))


class Cell:
    """One process's run of a cell: the program's objects, the frames
    and the feeder."""

    def __init__(self, cfg_mod: dict, traffic: dict, seed: int, *, device,
                 chips: int = 1, overrides: dict | None = None):
        from gaus_slam_tpu_torch.parallel import devices_from_config
        from gaus_slam_tpu_torch.scripts.gaus import seed_everything
        from gaus_slam_tpu_torch.slam.backend import Backend
        from gaus_slam_tpu_torch.slam.frontend import Frontend
        from gaus_slam_tpu_torch.utils.config import probe_cameras

        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.frames = FrameStream(cfg_mod["CAMERA"], traffic, seed,
                                  self.device)
        config = copy.deepcopy(cfg_mod["CONFIG"])
        for group, kv in (overrides or {}).items():
            config.setdefault(group, {}).update(kv)
        self.config = config
        seed_everything(config.get("seed", 0))
        color0, _, k, _ = self.frames[0]
        probe_cameras(config, color0, k)
        self.to_backend: queue.Queue = queue.Queue()
        self.frontend = Frontend(config, self.to_backend, device=self.device)
        devices = devices_from_config(config, self.device, n_avail=chips)
        self.backend = Backend(config, device=self.device, devices=devices)
        self.sleep_time = float(config["backend"].get("sleep_time", 0.01))
        self.data_flow: queue.Queue = queue.Queue()
        self.stop_event = threading.Event()
        self.feeder = None
        self.trace = False
        # what the run measured, read by the metric files (metrics/*.py)
        self.rec = dict(frontend_s=0.0, backend_s=0.0, staging_wait_s=0.0,
                        tasks=0, frames=0, failed=0)
        self.in_window = False
        self.prof = None         # a started torch.profiler, stopped by
        self.prof_stop = None    # the window at this host time
        self.t_first = None      # first window frame's hand-off
        self.t_last_ret = None   # last window frame's return
        self.first_window_t = None

    # ------------------------------------------------------------------
    def start_feeder(self):
        from gaus_slam_tpu_torch.scripts.gaus_mp import datafeeder

        self.feeder = threading.Thread(
            target=datafeeder,
            args=(self.frames, N_FRAMES, self.data_flow, self.stop_event, 0,
                  self.device), daemon=True)
        self.feeder.start()

    def stop_feeder(self):
        self.stop_event.set()
        if self.feeder is not None:
            while self.feeder.is_alive():
                # the feeder may wait on a full queue: keep it moving
                with contextlib.suppress(queue.Empty):
                    self.data_flow.get_nowait()
                self.feeder.join(timeout=0.05)

    @contextlib.contextmanager
    def _span(self, name: str, key: str):
        """A frontend or backend call; fenced and timed when tracing."""
        if not (self.trace and self.in_window):
            yield
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            torch.cuda.synchronize()
        self.rec[key] += time.perf_counter() - t0

    def turn(self, handing: bool) -> bool:
        """One turn of the driver's loop; True when a frame was processed."""
        from gaus_slam_tpu_torch.scripts.gaus_mp import _receive

        fe, be = self.frontend, self.backend
        took = False
        if handing and not self.data_flow.empty():
            msg = self.data_flow.get()
            if isinstance(msg, Exception):
                raise RuntimeError("the data feeder failed") from msg
            t, color, depth, c2w, event = msg
            if self.in_window and self.t_first is None:
                self.t_first = time.perf_counter()
                self.first_window_t = t
            color, depth = _receive(color, depth, event)
            with self._span("slambench.frontend", "frontend_s"):
                fe.process_frame(t, color, depth, c2w)
            took = True
            if self.in_window:
                self.t_last_ret = time.perf_counter()
                self.rec["frames"] += 1
                loss = (fe.last_track or {}).get("loss", 0.0)
                if not (np.isfinite(fe.vel).all() and np.isfinite(loss)):
                    self.rec["failed"] += 1
        if not self.to_backend.empty():
            with self._span("slambench.backend", "backend_s"):
                be.process_localmap(self.to_backend.get(), multi_process=True)
        for _ in range(4):
            idle = handing and self.data_flow.empty()
            if not (be.task_queue or idle):
                break
            n0 = len(be.task_queue)
            with self._span("slambench.backend", "backend_s"):
                be.process()
            if self.in_window:
                self.rec["tasks"] += max(n0 - len(be.task_queue), 0)
        if handing and self.data_flow.empty() and self.sleep_time:
            t0 = time.perf_counter()
            time.sleep(self.sleep_time)
            if self.in_window:
                self.rec["staging_wait_s"] += time.perf_counter() - t0
        return took

    def drain(self):
        """Turns without frames until the backend has nothing left."""
        while not (self.to_backend.empty() and not self.backend.task_queue):
            self.turn(handing=False)
        self.backend.wait()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def warm_up(self, cuts: int = WARMUP_CUTS):
        while self.frontend.cur_lmid < cuts:
            self.turn(handing=True)
        self.drain()

    def window(self, seconds: float, trace: bool = False) -> dict:
        """The timed window; returns the record."""
        from gaus_slam_tpu_torch.ops import _cuda

        rec = self.rec
        self.trace = trace
        rec["captures0"] = _captures()
        self.in_window = True
        deadline = None
        while True:
            handing = deadline is None or time.perf_counter() < deadline
            self.turn(handing)
            if self.prof is not None and time.perf_counter() >= self.prof_stop:
                t0 = time.perf_counter()
                rec["traced_s"] = t0 - rec["prof_t0"]
                self.prof.stop()
                self.prof = None
                # the profiler's own work, left out of the drain below
                rec["prof_stop_s"] = time.perf_counter() - t0
                rec["prof_stop_at"] = t0
            if deadline is None and self.t_first is not None:
                deadline = self.t_first + seconds
            if not handing and self.to_backend.empty() \
                    and not self.backend.task_queue:
                break
        self.backend.wait()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        self.in_window = False
        drain = t_end - self.t_last_ret
        if rec.get("prof_stop_at", 0.0) > self.t_last_ret:
            drain -= rec["prof_stop_s"]
        rec.update(t_first=self.t_first, t_end=t_end,
                   window_s=t_end - self.t_first, drain_s=drain,
                   first_window_t=self.first_window_t,
                   captures=_captures() - rec["captures0"])
        if self.device.type == "cuda":
            rec["peak_bytes"] = int(torch.cuda.max_memory_reserved())
        rec["launches"] = dict(_cuda.LAUNCHES)
        return rec
