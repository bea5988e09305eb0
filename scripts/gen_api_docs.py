#!/usr/bin/env python
"""Generate docs/api.md — the public API reference — by introspection.

The analog of the reference's sphinx ``autosummary`` pages
(reference ``docs/source/topics/api.rst`` + ``_autosummary/``): one
markdown section per public module, listing public classes (with their
public methods) and functions, each with its signature and docstring
summary. Run from the repo root:

    JAX_PLATFORMS=cpu python scripts/gen_api_docs.py

Re-run whenever public signatures change; ``scripts/build_docs.py``
renders the result into the HTML site.
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")

# (module, one-line override or None). Order = page order.
MODULES = [
    ("gym_anm_tpu", None),
    ("gym_anm_tpu.core.grid", None),
    ("gym_anm_tpu.core.state", None),
    ("gym_anm_tpu.core.transition", None),
    ("gym_anm_tpu.core.obs", None),
    ("gym_anm_tpu.core.env_core", None),
    ("gym_anm_tpu.ops.power_flow", None),
    ("gym_anm_tpu.ops.tree_nr", None),
    ("gym_anm_tpu.ops.tree_cuda", None),
    ("gym_anm_tpu.ops.projection", None),
    ("gym_anm_tpu.ops.linalg", None),
    ("gym_anm_tpu.envs.anm_env", None),
    ("gym_anm_tpu.envs.batched", None),
    ("gym_anm_tpu.envs.vector", None),
    ("gym_anm_tpu.envs.utils", None),
    ("gym_anm_tpu.envs.anm6.anm6", None),
    ("gym_anm_tpu.envs.anm6.anm6_easy", None),
    ("gym_anm_tpu.envs.feeder33", None),
    ("gym_anm_tpu.envs.feeder141", None),
    ("gym_anm_tpu.envs.feeder_envs", None),
    ("gym_anm_tpu.agents.mpc", None),
    ("gym_anm_tpu.agents.mpc_constant", None),
    ("gym_anm_tpu.agents.mpc_perfect", None),
    ("gym_anm_tpu.parallel.sharding", None),
    ("gym_anm_tpu.rl.ppo", None),
    ("gym_anm_tpu.rl.sac", None),
    ("gym_anm_tpu.rl.mlp", None),
    ("gym_anm_tpu.runtime", None),
    ("gym_anm_tpu.envs.randomized", None),
    ("gym_anm_tpu.render.rendering", None),
    ("gym_anm_tpu.render.servers", None),
    ("gym_anm_tpu.simulator.facade", None),
    ("gym_anm_tpu.constants", None),
    ("gym_anm_tpu.errors", None),
    ("gym_anm_tpu.utils", None),
    ("gym_anm_tpu.checkpoint", None),
    ("gym_anm_tpu.profiling", None),
]


def summary(obj) -> str:
    """First paragraph of the docstring, joined to one block."""
    doc = inspect.getdoc(obj) or ""
    para: list[str] = []
    for line in doc.split("\n"):
        if not line.strip():
            break
        para.append(line.strip())
    return " ".join(para)


def sig_of(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def public_members(mod):
    """(classes, functions) defined in (or exported by) this module."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    classes, funcs = [], []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None:
            continue
        owner = getattr(obj, "__module__", None)
        # Skip re-exports of other modules' members unless __all__ lists them.
        if getattr(mod, "__all__", None) is None and owner != mod.__name__:
            continue
        if inspect.isclass(obj):
            classes.append((n, obj))
        elif inspect.isfunction(obj):
            funcs.append((n, obj))
    return classes, funcs


def class_section(name: str, cls) -> list[str]:
    out = [f"### class `{name}{sig_of(cls)}`", ""]
    s = summary(cls)
    if s:
        out += [s, ""]
    methods = []
    for mname, m in inspect.getmembers(cls, predicate=inspect.isfunction):
        if mname.startswith("_") or m.__qualname__.split(".")[0] != cls.__name__:
            continue
        methods.append((mname, m))
    props = [
        (pname, p)
        for pname, p in inspect.getmembers(cls, lambda o: isinstance(o, property))
        if not pname.startswith("_")
        and p.fget is not None
        and p.fget.__qualname__.split(".")[0] == cls.__name__
    ]
    for mname, m in methods:
        out.append(f"- `{mname}{sig_of(m)}` — {summary(m) or 'no docstring'}")
    for pname, p in props:
        out.append(f"- `{pname}` (property) — {summary(p.fget) or 'no docstring'}")
    if methods or props:
        out.append("")
    return out


def func_section(name: str, fn) -> list[str]:
    out = [f"### `{name}{sig_of(fn)}`", ""]
    s = summary(fn)
    if s:
        out += [s, ""]
    return out


def main() -> int:
    lines = [
        "# API reference",
        "",
        "Auto-generated from docstrings by `scripts/gen_api_docs.py` — the",
        "analog of the reference's sphinx autosummary API pages. Each entry",
        "shows the public signature and the docstring summary; see the",
        "source docstrings for full parameter documentation.",
        "",
    ]
    for modname, _ in MODULES:
        mod = importlib.import_module(modname)
        lines += [f"## `{modname}`", ""]
        s = summary(mod)
        if s:
            lines += [s, ""]
        classes, funcs = public_members(mod)
        if not classes and not funcs:
            # Data/constant modules: list public names only.
            names = [n for n in vars(mod) if not n.startswith("_") and not inspect.ismodule(getattr(mod, n))]
            if names:
                lines.append("Public names: " + ", ".join(f"`{n}`" for n in sorted(names)))
                lines.append("")
            continue
        for n, c in classes:
            lines += class_section(n, c)
        for n, f in funcs:
            lines += func_section(n, f)
    path = os.path.join(ROOT, "docs", "api.md")
    with open(path, "w") as fh:
        fh.write("\n".join(lines).rstrip() + "\n")
    print(f"wrote {os.path.relpath(path, ROOT)} ({len(lines)} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
