"""Locate the vendored parity corpus (example/ at the repo root)."""
import pathlib

_REPO = pathlib.Path(__file__).resolve().parent.parent.parent


def example_dir() -> pathlib.Path:
    return _REPO / 'example'


def example_path(*parts: str) -> str:
    return str(example_dir().joinpath(*parts))
