"""Shared AST utilities for the rule modules."""
from __future__ import annotations

import ast
from typing import Iterator


def dotted(node: ast.expr) -> str:
    """Best-effort dotted name for a call target: ``jax.jit`` → "jax.jit"."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def walk_functions(tree: ast.Module) -> Iterator[ast.FunctionDef | ast.AsyncFunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def calls_in(node: ast.AST) -> Iterator[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def call_name_targets(call: ast.Call) -> list[str]:
    """Plain-Name function arguments of a call (``jax.jit(f)`` → ["f"]),
    looking through ``functools.partial(f, ...)`` one level."""
    out = []
    for arg in call.args:
        if isinstance(arg, ast.Name):
            out.append(arg.id)
        elif isinstance(arg, ast.Call) and dotted(arg.func).endswith("partial"):
            for inner in arg.args[:1]:
                if isinstance(inner, ast.Name):
                    out.append(inner.id)
    for kw in call.keywords:
        if isinstance(kw.value, ast.Name):
            out.append(kw.value.id)
    return out


def is_string(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def string_value(node: ast.expr) -> str | None:
    if is_string(node):
        return node.value
    return None


def fstring_template(node: ast.JoinedStr) -> str:
    """Render an f-string with dynamic parts as a ``\\x00`` sentinel:
    ``f"fault:{a}->{b}"`` → ``"fault:\\x00->\\x00"``."""
    parts = []
    for piece in node.values:
        if isinstance(piece, ast.Constant) and isinstance(piece.value, str):
            parts.append(piece.value)
        else:
            parts.append("\x00")
    return "".join(parts)


def module_import_time_nodes(tree: ast.Module) -> Iterator[ast.stmt]:
    """Statements executed at import time: module body plus class bodies,
    recursing through ``if``/``try`` at module level, but never into
    function bodies."""

    def visit(stmts):
        for node in stmts:
            yield node
            if isinstance(node, ast.ClassDef):
                yield from visit(node.body)
            elif isinstance(node, ast.If):
                yield from visit(node.body)
                yield from visit(node.orelse)
            elif isinstance(node, ast.Try):
                yield from visit(node.body)
                for h in node.handlers:
                    yield from visit(h.body)
                yield from visit(node.orelse)
                yield from visit(node.finalbody)
            elif isinstance(node, (ast.With, ast.For, ast.While)):
                yield from visit(node.body)
                yield from visit(getattr(node, "orelse", []))

    yield from visit(tree.body)


def enclosing_main_guard(tree: ast.Module, target: ast.stmt) -> bool:
    """Is ``target`` (a module-level statement) under ``if __name__ == ...``?"""
    for node in tree.body:
        if isinstance(node, ast.If):
            test = node.test
            names = {dotted(c) for c in ast.walk(test) if isinstance(c, ast.Name)}
            if "__name__" in names:
                for sub in ast.walk(node):
                    if sub is target:
                        return True
    return False
