"""Datasets of the port (reference datasets/__init__.py:4-28): the
procedural synthetic scene. The file-based loaders of the JAX package
(data/basedataset.py: Replica, TUM, ScanNet, ...) are not ported yet."""
from __future__ import annotations


def get_dataset(data_cfg: dict):
    name = data_cfg["dataset_name"].lower()
    if name == "synthetic":
        from .synthetic import SyntheticDataset

        return SyntheticDataset(
            height=data_cfg.get("desired_image_height", 120),
            width=data_cfg.get("desired_image_width", 160),
            num_frames=data_cfg.get("num_frames_total", 60),
            seed=data_cfg.get("seed", 0),
        )
    raise NotImplementedError(
        f"dataset {name!r}: the port has the synthetic scene only; the "
        f"file-based loaders wait for ROADMAP queue 1 item 2 (dataset "
        f"loaders, data/basedataset.py)")
