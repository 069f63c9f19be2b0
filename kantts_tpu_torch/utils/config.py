"""Config loading: YAML load + two-file merge + provenance stamping (a copy
of ``kantts_tpu/utils/config.py``).

As in KAN-TTS's training CLIs, the dataset directory's ``audio_config.yaml``
is loaded first and then ``dict.update``-ed with the model config, so
model-config keys win; the merged config is stamped with ``create_time`` and
the current git revision and re-dumped into the stage dir.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Any, Dict, Optional

import yaml


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def dump_yaml(config: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(config, f, sort_keys=False)


def git_revision_hash(cwd: Optional[str] = None) -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return "unknown"


def merge_configs(audio_config: Dict[str, Any], model_config: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """Shallow merge: model-config keys override audio-config keys."""
    merged = dict(audio_config or {})
    merged.update(model_config or {})
    return merged


def load_merged_config(root_dir: str, model_config_path: str) -> Dict[str, Any]:
    """Load ``<root_dir>/audio_config.yaml`` then overlay the model config."""
    audio_config_path = os.path.join(root_dir, "audio_config.yaml")
    audio_config: Dict[str, Any] = {}
    if os.path.exists(audio_config_path):
        audio_config = load_yaml(audio_config_path)
    return merge_configs(audio_config, load_yaml(model_config_path))


def stamp_and_dump(config: Dict[str, Any], stage_dir: str) -> Dict[str, Any]:
    config = dict(config)
    config["create_time"] = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
    config["git_revision_hash"] = git_revision_hash()
    dump_yaml(config, os.path.join(stage_dir, "config.yaml"))
    return config
