"""``docs/API_TORCH.md``, the port's API page, against ``docs/API.md`` and
the port itself.

Every name of ``nerf_rs_tpu_torch.__all__`` and every name that
``docs/API.md`` sets in bold must appear on the port's page, and each
either resolves by import in the port (relative to its section's module,
the package, or one of the section package's modules) or is listed under
the page's "Not ported" heading.
"""

import importlib
import pkgutil
import re
from pathlib import Path

import pytest

import nerf_rs_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
JAX_PAGE = (ROOT / "docs" / "API.md").read_text()
PORT_PAGE = (ROOT / "docs" / "API_TORCH.md").read_text()
NOT_PORTED = PORT_PAGE.split("\n## Not ported\n", 1)[1]


def _bold_names():
    """(section module, name) for every code span set in bold in
    docs/API.md: ``a / b`` spans give each name, arguments are cut, and a
    dotted first name lends its module to the bare names after it in the
    same bold span (``image.save_ppm / load_ppm``)."""
    out = []
    # A "**" inside code (``**kw``) is no bold marker.
    page = re.sub(r"`[^`]*`", lambda m: m.group(0).replace("**", "\0\0"), JAX_PAGE)
    for section in re.split(r"\n(?=## )", page):
        head = re.match(r"## `nerf_rs_tpu\.([\w.]+)`", section)
        module = head.group(1) if head else ""
        for bold in re.findall(r"\*\*(.+?)\*\*", section, re.S):
            prefix = ""
            for span in re.findall(r"`([^`]+)`", bold):
                while re.search(r"\([^()]*\)", span):         # argument lists
                    span = re.sub(r"\([^()]*\)", "", span)
                for name in (n.strip() for n in span.split("/")):
                    if not name:
                        continue
                    if "." in name and "=" not in name:
                        prefix = name.rsplit(".", 1)[0] + "."
                    elif prefix:
                        name = prefix + name
                    out.append((module, name))
    return out


BOLD = _bold_names()


def _lookup(dotted: str):
    """The object ``nerf_rs_tpu_torch.<dotted>`` names — the longest
    importable module prefix, then attributes — or None."""
    parts = dotted.split(".")
    for cut in range(len(parts), -1, -1):
        try:
            obj = importlib.import_module(".".join(["nerf_rs_tpu_torch", *parts[:cut]]))
        except ImportError:
            continue
        for part in parts[cut:]:
            if not hasattr(obj, part):
                return None
            obj = getattr(obj, part)
        return obj
    return None


def _resolves(module: str, name: str) -> bool:
    if "=" in name:                                  # impl="int8": a RenderConfig value
        from nerf_rs_tpu_torch.config import RenderConfig
        from nerf_rs_tpu_torch.render import get_mlp_fn

        field, value = name.split("=")
        get_mlp_fn(RenderConfig(**{field: value.strip('"')}))
        return True
    bases = [module, ""] if module else [""]
    pkg = _lookup(module) if module else None
    if pkg is not None and hasattr(pkg, "__path__"):
        bases += [f"{module}.{m.name}" for m in pkgutil.iter_modules(pkg.__path__)]
    return any(_lookup(f"{base}.{name}" if base else name) is not None for base in bases)


def _on_page(name: str, page: str) -> bool:
    """``name``, or the last part of a dotted name, inside a code span of
    ``page``."""
    last = name if "=" in name else name.rsplit(".", 1)[-1]
    return re.search(r"`[^`]*(?<!\w)" + re.escape(last) + r"(?!\w)[^`]*`", page) is not None


def test_the_jax_page_yields_its_bold_names():
    names = {name for _, name in BOLD}
    assert len(BOLD) > 90
    for want in ("integrate", "encoded_dim", "image.load_png", "native.write_ppm",
                 'impl="int8qat"', "train_sharded.shard_batch", "ray_sharding"):
        assert want in names


@pytest.mark.parametrize("module,name", BOLD, ids=[f"{m}:{n}" for m, n in BOLD])
def test_every_bold_name_of_the_jax_page_is_on_the_port_page(module, name):
    assert _on_page(name, PORT_PAGE), name
    assert _resolves(module, name) or _on_page(name, NOT_PORTED), \
        f"{name} ({module}) neither resolves in the port nor is listed as not ported"


@pytest.mark.parametrize("name", sorted(nerf_rs_tpu_torch.__all__))
def test_every_exported_name_is_on_the_port_page(name):
    assert _on_page(name, PORT_PAGE.split("\n---\n", 1)[0]), name
    assert _lookup(name) is not None


def test_not_ported_names_do_not_resolve():
    """What the page lists as not ported is not in the port, and each entry
    gives its reason."""
    entries = re.findall(r"^- (.+?)(?=^- |\Z)", NOT_PORTED, re.M | re.S)
    assert len(entries) == 4
    for entry in entries:
        assert re.search(r"\s—\s", entry), entry
    for name in ("native.available", "ray_sharding", "replicated_sharding"):
        assert _on_page(name, NOT_PORTED)
        assert _lookup(f"io.{name}") is None and _lookup(f"parallel.mesh.{name}") is None
