"""General utilities (IO, timing, batching): copy of
``ebnerd_tpu/utils/misc.py``."""
from __future__ import annotations

import datetime as _dt
import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Generator, Iterable

import numpy as np

__all__ = [
    "read_json_file",
    "write_json_file",
    "read_yaml_file",
    "write_yaml_file",
    "time_it",
    "batch_items_generator",
    "unnest_dictionary",
    "compute_npratio",
    "convert_to_nested_list",
    "str_datetime_now",
    "get_object_variables",
    "get_torch_device",
    "create_lookup_dict",
    "repeat_by_list_values_from_matrix",
]


def read_json_file(path) -> dict:
    with open(path) as f:
        return json.load(f)


def write_json_file(obj: dict, path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, default=str, indent=2)


def read_yaml_file(path) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def write_yaml_file(obj: dict, path) -> None:
    import yaml

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.dump(obj, f)


@contextmanager
def time_it(name: str = "", enable: bool = True, log=print):
    """Wall-clock timing context (reference's decorator, _python.py:160-174)."""
    t0 = time.perf_counter()
    yield
    if enable:
        log(f"{name or 'block'}: {time.perf_counter() - t0:.3f}s")


def batch_items_generator(items: Iterable, batch_size: int) -> Generator[list, None, None]:
    """Yield fixed-size chunks (reference: _python.py:290-312)."""
    batch = []
    for it in items:
        batch.append(it)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def unnest_dictionary(d: dict, parent_key: str = "", sep: str = ".") -> dict:
    """Flatten nested dicts into dotted keys (reference: _python.py:315-347)."""
    out: dict[str, Any] = {}
    for k, v in d.items():
        key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if isinstance(v, dict):
            out.update(unnest_dictionary(v, key, sep))
        else:
            out[key] = v
    return out


def compute_npratio(n_pos: int, n_neg: int) -> float:
    """negatives per positive (reference: _python.py:243-254)."""
    return round(n_neg / n_pos, 2)


def convert_to_nested_list(flat: Iterable, sublist_size: int) -> list[list]:
    """Chunk a flat list into fixed-size sublists (reference: _python.py:359-367)."""
    flat = list(flat)
    return [flat[i : i + sublist_size] for i in range(0, len(flat), sublist_size)]


def str_datetime_now() -> str:
    return _dt.datetime.now().strftime("%Y-%m-%d %H:%M:%S")


def get_object_variables(obj) -> dict:
    """Public scalar attributes of an object (reference: _python.py:274-287)."""
    return {
        k: v
        for k, v in vars(obj).items()
        if not k.startswith("__") and not callable(v)
    }


def get_torch_device(use_gpu: bool = True) -> str:
    """'cuda'/'mps'/'cpu': which device this machine has
    (reference: _python.py:350-356). An answer to a question only: no path
    of the port picks its device with it (entry points take ``device``,
    the card unless the caller asks for the CPU)."""
    try:
        import torch

        if use_gpu and torch.cuda.is_available():
            return "cuda"
        if use_gpu and getattr(torch.backends, "mps", None) is not None \
                and torch.backends.mps.is_available():
            return "mps"
    except ImportError:
        pass
    return "cpu"


def create_lookup_dict(rows: dict[Any, Any]) -> dict:
    """Identity shim kept for API parity (reference builds {key: value}
    dicts from dataframes, _python.py:391-409)."""
    return dict(rows)


def repeat_by_list_values_from_matrix(
    input_array: np.ndarray, matrix: np.ndarray, repeats: np.ndarray
) -> np.ndarray:
    """np.repeat(matrix[input], repeats) — the reference's eval-mode
    history broadcast (reference: _python.py:370-388). Kept for parity;
    the eval feeds use masked batching instead of explode."""
    return np.repeat(matrix[np.asarray(input_array)], np.asarray(repeats), axis=0)
