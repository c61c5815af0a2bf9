"""Dataset registry (port of the JAX ``utils/registry.py``), JSON-compatible
with the reference's ``dataset_config.json``: the missingness statistics
of the reference's three datasets as built-in defaults, the source-path
index of ``dataset_info.csv`` / ``dataset_info_all.csv`` (the ``_all``
variant adds LSA64, which has no statistics), and user JSON overlays of
the same schema.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

from ..transforms.corruption import DatasetMissingStats

_BUILTIN: Dict[str, dict] = {
    "AUTSL": {
        "mean_consecutive_missing": 5.28,
        "std_consecutive_missing": 4.15,
        "samples": 491,
        "mean_number_missing_blocks": 4.18,
        "std_number_missing_blocks": 1.78,
    },
    "AEC": {
        "mean_consecutive_missing": 3.25,
        "std_consecutive_missing": 3.09,
        "samples": 267,
        "mean_number_missing_blocks": 1.92,
        "std_number_missing_blocks": 1.1,
    },
    "PUCP_PSL_DGI305": {
        "mean_consecutive_missing": 4.04,
        "std_consecutive_missing": 5.63,
        "samples": 185,
        "mean_number_missing_blocks": 1.66,
        "std_number_missing_blocks": 1.11,
    },
}

# dataset_info.csv rows; LSA64 appears only in dataset_info_all.csv
_BUILTIN_PATHS: Dict[str, dict] = {
    "AEC": {
        "hdf5_file": "../PeruvianSignLanguage/Data/AEC/AEC--mediapipe.hdf5",
        "csv_file": "../missingValueAnalisys/"
                    "AEC_without_missing_values.csv",
    },
    "PUCP_PSL_DGI305": {
        "hdf5_file": "../PeruvianSignLanguage/Data/PUCP_PSL_DGI305/"
                     "PUCP_PSL_DGI305--mediapipe.hdf5",
        "csv_file": "../missingValueAnalisys/"
                    "PUCP_PSL_DGI305_without_missing_values.csv",
    },
    "AUTSL": {
        "hdf5_file": "../PeruvianSignLanguage/Data/AUTSL/"
                     "AUTSL--mediapipe.hdf5",
        "csv_file": "../missingValueAnalisys/"
                    "AUTSL_without_missing_values.csv",
    },
    "LSA64": {
        "hdf5_file": "../PeruvianSignLanguage/Data/LSA64/"
                     "LSA64--mediapipe.hdf5",
        "csv_file": "../missingValueAnalisys/"
                    "LSA64_without_missing_values.csv",
        "all_index_only": True,
    },
}


def load_registry(path: Optional[str] = None,
                  include_all_index: bool = True) -> Dict[str, dict]:
    """The built-in registry (statistics and source paths), overlaid with
    a dataset_config.json when ``path`` is given.
    ``include_all_index=False`` keeps only dataset_info.csv's rows."""
    reg = {k: dict(v) for k, v in _BUILTIN.items()}
    for name, paths in _BUILTIN_PATHS.items():
        if not include_all_index and paths.get("all_index_only"):
            continue
        reg.setdefault(name, {}).update(
            {k: v for k, v in paths.items() if k != "all_index_only"})
    if path:
        with open(path) as f:
            for name, cfg in json.load(f).items():
                reg.setdefault(name, {}).update(cfg)
    return reg


def missing_stats(dataset_name: str,
                  path: Optional[str] = None) -> Optional[DatasetMissingStats]:
    """The statistics of the per-dataset corruption mode; None for
    'all'.  Raises KeyError for a dataset without statistics."""
    if dataset_name == "all":
        return None
    cfg = load_registry(path).get(dataset_name)
    if cfg is None or "mean_consecutive_missing" not in cfg:
        raise KeyError(f"dataset {dataset_name!r} has no missingness stats "
                       "in the registry; add them to dataset_config.json")
    return DatasetMissingStats(
        mean_consecutive_missing=cfg["mean_consecutive_missing"],
        std_consecutive_missing=cfg["std_consecutive_missing"],
        mean_number_missing_blocks=cfg["mean_number_missing_blocks"],
        std_number_missing_blocks=cfg["std_number_missing_blocks"],
        samples=int(cfg["samples"]),
    )


def dataset_name_from_path(path: str) -> str:
    """'data/validation--AUTSL.hdf5' -> 'AUTSL'."""
    return path.split("--")[-1].split(".")[0]
