"""Pipelined SLAM driver of the port (port of scripts/gaus_mp.py;
reference scripts/gaus_mp.py).

    python -m gaus_slam_tpu_torch.scripts.gaus_mp <config.py> \
        [--backend pallas|interpret|reference] [--device cuda|cpu] \
        [--resume <vis_base_dir>/ckpt]

The reference runs its data feeder, frontend and backend as three
processes joined by CUDA-tensor queues. Here one process holds the card:

  * a feeder thread reads and quantizes frames ahead of the frontend
    (uint8 colour, uint16 depth: utils/stage.py) and copies each into
    pinned host memory, then to the card on a copy stream of its own,
    behind the compute; the frontend's stream waits on the copy's event
    before it reads the frame;
  * the loop takes one frame per turn through the Frontend, merges a cut
    submap into the Backend, and drains up to four backend tasks;
  * with ``tpu.backend_device`` the Backend queues its work on a CUDA
    stream of its own (or on a second card), so it runs on the device
    beside the frontend's next frame (slam/backend.py).

The turn structure, the feeder's backpressure (it sleeps while more than
5 frames wait) and the idle-time random refinement (only while the
frontend is starved for frames) are those of scripts/gaus_mp.py. Under
``backend.save_ckpt`` a checkpoint is written at every merge. The
frontend's dashboards are drawn only under backend.common_vis, as the
backend's are (matplotlib, which draws them, may be missing on the
card's machine).
"""
from __future__ import annotations

import argparse
import os
import queue
import threading
import time

import numpy as np
import torch

from .gaus import end_run, start_run


def datafeeder(dataset, num_frames: int, data_flow: queue.Queue,
               stop_event: threading.Event, start_frame: int = 0,
               device="cpu"):
    """Read, quantize and stage frames start_frame .. num_frames-1 (the
    reference's DataFeeder, gaus_mp.py:68-79), then put "finish".

    Each item is (t, color u8 [H, W, 3], depth u16 [H, W] (float32 past
    the 10 m ceiling), c2w, event). On a card the two images are copied
    from pinned memory on a copy stream of this thread's own, and
    ``event`` marks the copy's end: the consumer makes its stream wait on
    it and calls ``record_stream`` on both tensors before it reads them.
    On the CPU they are host tensors and ``event`` is None. An error is
    put on the queue for the consumer to raise."""
    try:
        _feed(dataset, num_frames, data_flow, stop_event, start_frame,
              torch.device(device))
    except Exception as e:  # noqa: BLE001 - the consumer re-raises it
        data_flow.put(e)


def _feed(dataset, num_frames, data_flow, stop_event, start_frame, device):
    from ..utils.stage import pack_frame

    copy_stream = None
    if device.type == "cuda":
        torch.cuda.set_device(device)   # this thread's CUDA calls
        copy_stream = torch.cuda.Stream(device=device)
    for t in range(start_frame, num_frames):
        if stop_event.is_set():
            return
        while data_flow.qsize() > 5:
            if stop_event.is_set():
                return
            time.sleep(0.01)
        color, depth, _, c2w = dataset[t]
        depth = np.asarray(depth)
        if depth.ndim == 3:
            depth = depth[..., 0]
        color8, depth_t = pack_frame(color, depth)
        color8, depth_t = torch.from_numpy(color8), torch.from_numpy(depth_t)
        event = None
        if copy_stream is not None:
            with torch.cuda.stream(copy_stream):
                color8 = color8.pin_memory().to(device, non_blocking=True)
                depth_t = depth_t.pin_memory().to(device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(copy_stream)
        data_flow.put((t, color8, depth_t, c2w, event))
    data_flow.put("finish")


def _receive(color, depth, event):
    """A staged frame, ready for the current stream to read."""
    if event is not None:
        cur = torch.cuda.current_stream()
        cur.wait_event(event)
        color.record_stream(cur)
        depth.record_stream(cur)
    return color, depth


def rgbd_slam(config: dict, backend: str = "pallas", device="cuda",
              resume_from: str | None = None) -> dict:
    from ..utils.checkpoint import save_run_state

    (device, dataset, num_frames, to_backend, frontend, backend_, wandb_run,
     t0_frame) = start_run(config, backend, device, resume_from)
    data_flow: queue.Queue = queue.Queue()
    stop_event = threading.Event()
    sleep_time = float(config["backend"].get("sleep_time", 0.01))
    out_dir = config.get("vis_base_dir", "output")
    common_vis = bool(config["backend"].get("common_vis", False))
    save_ckpt = bool(config["backend"].get("save_ckpt", False))
    last_frame = t0_frame - 1

    feeder = threading.Thread(
        target=datafeeder,
        args=(dataset, num_frames, data_flow, stop_event, t0_frame, device),
        daemon=True)
    feeder.start()
    t_start = time.perf_counter()
    finished = False
    try:
        while not (finished and data_flow.empty() and to_backend.empty()
                   and not backend_.task_queue):
            # frontend: one frame per turn
            if not data_flow.empty():
                msg = data_flow.get()
                if isinstance(msg, Exception):
                    raise RuntimeError("the data feeder failed") from msg
                if isinstance(msg, str) and msg == "finish":
                    finished = True
                    frontend.process_final()
                else:
                    t, color, depth, c2w, event = msg
                    color, depth = _receive(color, depth, event)
                    frontend.process_frame(t, color, depth, c2w)
                    last_frame = t
                    if common_vis and t % 10 == 0:
                        # reference mp_Frontend.run:277-278
                        frontend.update_common_visualization()
            # backend: absorb a submap, then drain a few tasks
            if not to_backend.empty():
                backend_.process_localmap(to_backend.get(),
                                          multi_process=True)
                backend_.update_common_visualization()  # Backend.py:366
                if save_ckpt:
                    # the checkpoint waits for the backend's stream
                    save_run_state(os.path.join(out_dir, "ckpt"), frontend,
                                   backend_, next_frame_idx=last_frame + 1)
            for _ in range(4):
                if backend_.task_queue:
                    backend_.process()
                elif data_flow.empty() and not finished:
                    # idle (the frontend is starved for frames): the
                    # reference's random_process fills exactly these gaps
                    # (Backend.py:192-194)
                    backend_.process()
                else:
                    break
            if sleep_time:
                time.sleep(sleep_time if data_flow.empty() else 0)
    finally:
        stop_event.set()
        feeder.join()
    backend_.wait()
    total = time.perf_counter() - t_start

    backend_.final_refine(progress=True)
    frontend.total_time = total
    return end_run(config, frontend, backend_, dataset, wandb_run, backend,
                   device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "interpret", "reference"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--resume", default=None,
                    help="resume from a mid-run checkpoint dir")
    args = ap.parse_args(argv)

    from ..utils.config import load_config

    return rgbd_slam(load_config(args.config), backend=args.backend,
                     device=args.device, resume_from=args.resume)


if __name__ == "__main__":
    main()
