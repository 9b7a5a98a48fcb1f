"""The run-time check for the JAX package: whole top-level names, and a run
that finds one prints no result and fails."""

from __future__ import annotations

import sys
import types

from portbench.lib.guard import forbidden_loaded


def test_whole_top_level_names():
    assert forbidden_loaded(["pde_surrogate_torch", "pde_surrogate_torch.uq",
                             "jaxtyping", "flaxen", "optax_like",
                             "pde_surrogate_tpux"]) == []
    assert forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen", "optax",
                             "pde_surrogate_tpu.models", "numpy"]) == [
        "flax", "jax", "jaxlib", "optax", "pde_surrogate_tpu"]


def test_run_with_jax_loaded_fails_without_result(tiny_root, no_forbidden,
                                                  monkeypatch, capsys):
    from portbench.tests.conftest import run_tiny
    monkeypatch.setitem(sys.modules, "pde_surrogate_tpu.ops",
                        types.ModuleType("pde_surrogate_tpu.ops"))
    rc, _ = run_tiny(tiny_root, "codec-sobel-train")
    captured = capsys.readouterr()
    assert rc != 0
    assert captured.out.strip() == ""
    assert "pde_surrogate_tpu" in captured.err


def test_no_card_no_result(monkeypatch, capsys):
    """Without a CUDA device the benchmark exits non-zero and prints no
    result."""
    import time

    import torch

    from portbench.harness import run_cell
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_cell(["--workload", "codec-sobel-train", "--seed", "1",
                   "--seconds", "1"], t_start=time.perf_counter())
    assert rc != 0 and capsys.readouterr().out == ""


def test_sources_import_no_jax():
    """No file of the benchmark imports the JAX package by name."""
    import ast
    import os

    from portbench.harness import ROOT
    for dp, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dp, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module] if isinstance(node, ast.ImportFrom)
                         and node.module and node.level == 0 else [])
                assert not forbidden_loaded(names), (f, names)
