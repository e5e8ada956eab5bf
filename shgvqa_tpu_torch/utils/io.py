"""Small IO helpers: the port's own copy of ``shgvqa_tpu/utils/io.py``.

Several of the reference's ``data/*.json`` artifacts are pickle files
despite the extension; ``load_json_or_pickle`` sniffs the format so the
datasets accept either encoding.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any


def load_json(path: str | Path) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def load_pickle(path: str | Path) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def load_json_or_pickle(path: str | Path) -> Any:
    """Load a file that may be JSON text or a pickle with a .json name."""
    with open(path, "rb") as f:
        head = f.read(64)
    # JSON files start with whitespace/typical JSON punctuation in ASCII.
    try:
        head_text = head.decode("utf-8")
    except UnicodeDecodeError:
        return load_pickle(path)
    if head_text.lstrip()[:1] in ("{", "[", '"') or head_text.lstrip()[:1].isdigit():
        try:
            return load_json(path)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return load_pickle(path)
    return load_pickle(path)
