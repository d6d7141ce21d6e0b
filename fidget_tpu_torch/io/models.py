"""Model asset resolution.

Test/bench models (`.vm` tapes, `.rhai` scripts) are looked up from, in
order: `$FIDGET_TPU_MODELS` and a `models/` directory next to the repo
root. `.vm` text is compiled by the native tape compiler
(`native.compile_vm`) or parsed by `Context.from_text`; `.rhai` scripts
go through the mini script evaluator in `fidget_tpu_torch.script`.
"""

from __future__ import annotations

import os
import pathlib

from ..core.context import Context

_CANDIDATES = [
    os.environ.get("FIDGET_TPU_MODELS"),
    str(pathlib.Path(__file__).resolve().parents[2] / "models"),
]


def models_dir() -> pathlib.Path | None:
    for c in _CANDIDATES:
        if c and pathlib.Path(c).is_dir():
            return pathlib.Path(c)
    return None


def find_model(name: str) -> pathlib.Path:
    d = models_dir()
    if d is None:
        raise FileNotFoundError("no models directory found")
    p = d / name
    if not p.exists():
        raise FileNotFoundError(p)
    return p


def has_model(name: str) -> bool:
    try:
        find_model(name)
        return True
    except FileNotFoundError:
        return False


def load_vm(name: str) -> tuple[Context, int]:
    """Loads a `.vm` model by file name, returning (context, root node)."""
    path = find_model(name)
    return Context.from_text(path.read_text())


def load_script(name: str):
    """Loads a `.rhai` model by file name, returning the traced Tree."""
    from ..script import eval_script

    path = find_model(name)
    return eval_script(path.read_text()).tree


def load_vm_tape(name: str, reg_limit: int = 255):
    """Loads and lowers a `.vm` model straight to a register `Tape`
    through the native (C++) tape compiler; a failed build raises."""
    from ..native import compile_vm

    return compile_vm(find_model(name).read_text(), reg_limit)
