"""Hot-path marker for the ingest/serving data plane.

``@hot_path`` declares that a function sits on a per-batch (or per-request)
serving path and must not pay per-call setup costs. It is a no-op at
runtime — the value is static: dmlc-lint rule H1 (tools/lint/rules/hotpath.py)
forbids constructing ``ThreadPoolExecutor``/``threading.Thread`` inside any
marked function, which is the regression class the PR-2 ingest overhaul
removed (a fresh pool spawned and joined on every ``load_batch`` /
``run_paths_stream`` call). Build pools once at module or object scope
(``ops/preprocess._host_pool``, ``parallel/inference._stage_pool``) and
submit to them from the hot path instead. The naming convention ``*_hot``
marks a function the same way for code that cannot take a decorator.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def hot_path(fn: F) -> F:
    """Mark ``fn`` as a serving hot path (see module docstring)."""
    fn.__dmlc_hot_path__ = True  # type: ignore[attr-defined]
    return fn
