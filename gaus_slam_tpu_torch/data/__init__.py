"""Dataset factory (port of gaus_slam_tpu/data/__init__.py; reference
datasets/__init__.py:4-28): the procedural synthetic scene, and every
file-based loader of ``basedataset.DATASET_REGISTRY``."""
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

    from .basedataset import DATASET_REGISTRY

    if name not in DATASET_REGISTRY:
        raise ValueError(f"Unknown dataset {name}")
    cls = DATASET_REGISTRY[name]
    return cls(
        config_path=data_cfg.get("gradslam_data_cfg"),
        basedir=data_cfg["basedir"],
        sequence=data_cfg["sequence"],
        start=data_cfg.get("start", 0),
        end=data_cfg.get("end", -1),
        stride=data_cfg.get("stride", 1),
        desired_height=data_cfg.get("desired_image_height", 480),
        desired_width=data_cfg.get("desired_image_width", 640),
    )
