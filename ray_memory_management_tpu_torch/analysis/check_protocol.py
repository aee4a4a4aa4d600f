"""``protocol-additivity`` — transfer wire protocol v2 may only evolve
by ADDING keys.

The checker extracts every request/reply header key that
``core/transfer.py`` actually sends or reads, and compares the observed
sets against the generated registry ``analysis/protocol_schema.py``:

  * a schema key that no longer appears in the code is a REMOVAL or
    RENAME -> violation (old peers still send/expect it across a rolling
    upgrade — the v2 negotiation only works because unknown
    keys are ignored and known keys never change meaning);
  * an observed key missing from the schema is an ADDITION: by default
    it auto-registers (protocol_schema.py is regenerated, the diff is
    recorded in ``options["schema_diff"]`` for the CLI to print); in
    ``frozen`` mode (tier-1 CI) it is a violation, forcing the schema
    diff into the same commit as the protocol change.

Key extraction (core/transfer.py only):

  * dict literals containing ``"proto"`` are request headers; dict
    literals containing ``"size"``/``"error"``/``"deferred"`` are reply
    headers — their string keys are observed;
  * subscript writes/reads and ``.get("k")`` on variables named
    ``req``/``first_req`` (request side) or ``reply``/``hdr`` (reply
    side) are observed.

A third side covers the observability piggyback frames (the profiling
plane rides them): in ``core/worker.py`` and ``core/node_agent.py``,
dict literals whose ``"type"`` is ``"profile"`` (the worker's flush
frame) or ``"pong"`` (the agent's keepalive reply) plus subscript
writes/``get`` reads on variables named ``frame``/``pong`` observe the
``FRAME_KEYS`` set — same additive-only contract: the head ignores
unknown frame keys, so adding one is safe across a rolling upgrade and
removing one strands data old peers still send.
"""

from __future__ import annotations

import ast
import os
from typing import List, Set, Tuple

from .engine import Project, Violation, dict_literal_keys, const_str, \
    register

_TRANSFER_SUFFIX = "core/transfer.py"
_SCHEMA_SUFFIX = "analysis/protocol_schema.py"
_REQUEST_VARS = {"req", "first_req", "request"}
_REPLY_VARS = {"reply", "hdr", "header", "resp"}
_REPLY_MARKERS = {"size", "error", "deferred"}
# observability piggyback frames: worker flush frame + agent pong
_FRAME_SUFFIXES = ("core/worker.py", "core/node_agent.py")
_FRAME_VARS = {"frame", "pong"}
_FRAME_TYPES = {"profile", "pong"}


def observed_keys(project: Project) -> Tuple[Set[str], Set[str]]:
    """(request_keys, reply_keys) actually used by core/transfer.py."""
    req: Set[str] = set()
    rep: Set[str] = set()
    sf = project.get(_TRANSFER_SUFFIX)
    if sf is None or sf.tree is None:
        return req, rep
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Dict):
            keys = set(dict_literal_keys(node))
            if "proto" in keys:
                req |= keys
            elif keys & _REPLY_MARKERS:
                rep |= keys
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Name):
            key = const_str(node.slice)
            if key is None:
                continue
            if node.value.id in _REQUEST_VARS:
                req.add(key)
            elif node.value.id in _REPLY_VARS:
                rep.add(key)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get" and node.args and \
                isinstance(node.func.value, ast.Name):
            key = const_str(node.args[0])
            if key is None:
                continue
            if node.func.value.id in _REQUEST_VARS:
                req.add(key)
            elif node.func.value.id in _REPLY_VARS:
                rep.add(key)
    return req, rep


def observed_frame_keys(project: Project) -> Set[str]:
    """Frame keys actually sent by core/worker.py + core/node_agent.py."""
    frame: Set[str] = set()
    for suffix in _FRAME_SUFFIXES:
        sf = project.get(suffix)
        if sf is None or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Dict):
                keys = set(dict_literal_keys(node))
                if "type" not in keys:
                    continue
                for k, v in zip(node.keys, node.values):
                    if const_str(k) == "type" and \
                            const_str(v) in _FRAME_TYPES:
                        frame |= keys
                        break
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in _FRAME_VARS:
                key = const_str(node.slice)
                if key is not None:
                    frame.add(key)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "get" and node.args and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id in _FRAME_VARS:
                key = const_str(node.args[0])
                if key is not None:
                    frame.add(key)
    return frame


def schema_keys(project: Project
                ) -> Tuple[Set[str], Set[str], Set[str], str]:
    """(request_keys, reply_keys, frame_keys, path) from
    protocol_schema.py."""
    sf = project.get(_SCHEMA_SUFFIX)
    req: Set[str] = set()
    rep: Set[str] = set()
    frame: Set[str] = set()
    if sf is None or sf.tree is None:
        return req, rep, frame, ""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, (ast.Tuple, ast.List)):
            vals = {s for s in (const_str(e) for e in node.value.elts)
                    if s is not None}
            if node.targets[0].id == "REQUEST_KEYS":
                req = vals
            elif node.targets[0].id == "REPLY_KEYS":
                rep = vals
            elif node.targets[0].id == "FRAME_KEYS":
                frame = vals
    return req, rep, frame, sf.path


_HEADER = '''"""Generated wire-protocol v2 key registry — do not hand-edit key sets.

``rmt check`` (rule ``protocol-additivity``) regenerates this file when
core/transfer.py starts sending a NEW request/reply key (additive
evolution, the diff is printed), and FAILS when a key listed here stops
appearing in the code: removing or renaming a wire key breaks rolling
upgrades where old peers still send/expect it. In ``--frozen`` mode
(CI / tests/test_static_analysis.py) additions fail too, so the schema
diff lands in the same commit as the protocol change.
"""
'''


def _regenerate(path: str, req: Set[str], rep: Set[str],
                frame: Set[str]) -> None:
    def block(name: str, comment: str, keys: Set[str]) -> str:
        lines = [f"# {comment}", f"{name} = ("]
        lines += [f"    \"{k}\"," for k in sorted(keys)]
        lines.append(")")
        return "\n".join(lines)

    text = (_HEADER + "\n"
            + block("REQUEST_KEYS",
                    "v2 fetch request: client -> server header dict",
                    req)
            + "\n\n"
            + block("REPLY_KEYS",
                    "v2 fetch reply: server -> client header dict", rep)
            + "\n\n"
            + block("FRAME_KEYS",
                    "observability piggyback frames: worker flush frame "
                    "+ agent pong", frame)
            + "\n")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


@register("protocol-additivity")
def check_protocol_additivity(project: Project, options: dict
                              ) -> List[Violation]:
    out: List[Violation] = []
    obs_req, obs_rep = observed_keys(project)
    obs_frame = observed_frame_keys(project)
    sch_req, sch_rep, sch_frame, schema_path = schema_keys(project)
    if not schema_path:
        out.append(Violation(
            "protocol-additivity", _SCHEMA_SUFFIX, 1,
            "analysis/protocol_schema.py missing or unparseable"))
        return out
    if not obs_req and not obs_rep and not obs_frame:
        # sender files absent (e.g. fixture-only project): nothing to do
        return out
    schema_rel = os.path.relpath(schema_path, project.repo_root)

    # a side only votes when its sender file(s) are present and emit
    # keys — a fixture project without transfer.py must not see its
    # whole REQUEST_KEYS registry as "removed"
    sides: List[Tuple[str, Set[str], Set[str], str, str]] = []
    if obs_req or obs_rep:
        transfer_rel = project.get(_TRANSFER_SUFFIX).rel
        sides.append(("request", sch_req, obs_req, transfer_rel,
                      "transfer.py"))
        sides.append(("reply", sch_rep, obs_rep, transfer_rel,
                      "transfer.py"))
    if obs_frame:
        frame_sf = next((project.get(s) for s in _FRAME_SUFFIXES
                         if project.get(s) is not None), None)
        frame_rel = frame_sf.rel if frame_sf else _FRAME_SUFFIXES[0]
        sides.append(("frame", sch_frame, obs_frame, frame_rel,
                      "worker.py/node_agent.py"))

    for side, sch, obs, sender_rel, sender in sides:
        for key in sorted(sch - obs):
            out.append(Violation(
                "protocol-additivity", sender_rel, 1,
                f"wire {side} key {key!r} is registered in "
                f"protocol_schema.py but no longer sent/read by "
                f"{sender} — removing or renaming a v2 key breaks "
                f"rolling upgrades (additive-only protocol)"))
        added = sorted(obs - sch)
        if not added:
            continue
        if options.get("frozen"):
            for key in added:
                out.append(Violation(
                    "protocol-additivity", schema_rel, 1,
                    f"new wire {side} key {key!r} is not registered in "
                    f"protocol_schema.py — run `rmt check` to "
                    f"auto-register it and commit the schema diff"))
        else:
            options.setdefault("schema_diff", []).extend(
                f"+ {side} key {key!r}" for key in added)

    if not options.get("frozen") and \
            any(obs - sch for _, sch, obs, _, _ in sides):
        _regenerate(schema_path, sch_req | obs_req, sch_rep | obs_rep,
                    sch_frame | obs_frame)
    return out
