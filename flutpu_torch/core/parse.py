"""parse_launch — textual pipeline descriptions.

The framework's declarative config language, matching the gst-launch grammar
subset the reference uses (hype/tests/tests.rs pipelines, README examples):

    scenedetector gop-size=2 ! outputselector name=os
    os.src_0 ! identity sleep-time=10000 ! col.
    scenecollector name=col

Supports: factory instantiation with ``key=value`` props, named elements,
``!`` links, pad references ``name.pad`` / element references ``name.``,
forward references (resolved after the full description is parsed), and
quoted property values.
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, List, Optional, Tuple

from .bin import Bin, Pipeline
from .element import Element
from .pad import Pad, PadDirection
from .registry import exists, make


@dataclass
class _Endpoint:
    element_name: str
    pad_name: Optional[str]  # None = any/first-free (or request)


def _parse_value(v: str) -> Any:
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
        return v[1:-1]
    if "/" in v:
        parts = v.split("/", 1)
        if all(p.lstrip("-").isdigit() for p in parts):
            return Fraction(int(parts[0]), int(parts[1]))
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def parse_launch(description: str, toplevel: Optional[Bin] = None) -> Pipeline:
    """Build a pipeline from a textual description."""
    pipeline = toplevel if toplevel is not None else Pipeline()
    parse_bin_from_description(description, pipeline)
    return pipeline  # type: ignore[return-value]


def parse_bin_from_description(description: str, container: Bin) -> Bin:
    lexer = shlex.shlex(description, posix=True)
    lexer.whitespace_split = True
    lexer.commenters = ""
    tokens = list(lexer)

    elements: List[Element] = []
    links: List[Tuple[_Endpoint, _Endpoint]] = []
    by_name: dict = {}

    prev_endpoint: Optional[_Endpoint] = None
    expect_link = False
    current_el: Optional[Element] = None

    def finish_link(new_ep: _Endpoint):
        nonlocal expect_link, prev_endpoint
        if expect_link:
            assert prev_endpoint is not None
            links.append((prev_endpoint, new_ep))
            expect_link = False
        prev_endpoint = new_ep

    i = 0
    while i < len(tokens):
        tok = tokens[i]
        i += 1
        if tok == "!":
            if prev_endpoint is None:
                raise ValueError("dangling '!' with no upstream element")
            expect_link = True
            current_el = None
            continue
        if "=" in tok and current_el is not None and not expect_link:
            # property of the current element
            key, _, val = tok.partition("=")
            current_el.set_property(key, _parse_value(val))
            continue
        if _looks_like_pad_ref(tok, by_name, expect_link or prev_endpoint is None):
            elname, _, padname = tok.partition(".")
            finish_link(_Endpoint(elname, padname or None))
            current_el = None
            continue
        # otherwise: element factory followed by its property tokens
        if not exists(tok):
            raise ValueError(f"no element factory {tok!r}")
        props: List[Tuple[str, Any]] = []
        while i < len(tokens) and "=" in tokens[i] and tokens[i] != "!":
            key, _, val = tokens[i].partition("=")
            props.append((key, _parse_value(val)))
            i += 1
        el = make(tok)
        for key, val in props:
            if key == "name":
                el.name = str(val)
        elements.append(el)
        by_name[el.name] = el
        container.add(el)
        for key, val in props:
            if key != "name":
                el.set_property(key, val)
        current_el = el
        finish_link(_Endpoint(el.name, None))

    if expect_link:
        raise ValueError("description ends with dangling '!'")

    # resolve links (forward references allowed)
    for src_ep, sink_ep in links:
        src_el = container.get_by_name(src_ep.element_name)
        sink_el = container.get_by_name(sink_ep.element_name)
        if src_el is None or sink_el is None:
            missing = src_ep.element_name if src_el is None else sink_ep.element_name
            raise ValueError(f"unresolved element reference {missing!r}")
        src_pad = _resolve_pad(src_el, src_ep.pad_name, PadDirection.SRC)
        sink_pad = _resolve_pad(sink_el, sink_ep.pad_name, PadDirection.SINK)
        src_pad.link(sink_pad)
    return container


def _looks_like_pad_ref(tok: str, by_name: dict, at_chain_boundary: bool) -> bool:
    if "=" in tok or "!" in tok:
        return False
    if not tok.endswith(".") and "." not in tok:
        return False
    elname = tok.split(".", 1)[0]
    if not elname:
        return False
    # a pad-ref either names a known element or is a forward reference ending
    # in '.' / containing '.', and must not itself be a factory name
    if exists(tok):
        return False
    return True


def _resolve_pad(el: Element, pad_name: Optional[str], direction: PadDirection) -> Pad:
    if pad_name is not None:
        pad = el.get_pad(pad_name)
        if pad is None:
            pad = el.request_pad(pad_name)
        if pad is None:
            raise ValueError(f"{el.name} has no pad {pad_name!r}")
        if pad.direction != direction:
            raise ValueError(f"{el.name}:{pad_name} is not a {direction.value} pad")
        return pad
    candidates = el.src_pads() if direction == PadDirection.SRC else el.sink_pads()
    for pad in candidates:
        if not pad.is_linked():
            return pad
    req = el.request_pad("src_%u" if direction == PadDirection.SRC else "sink_%u")
    if req is not None:
        return req
    raise ValueError(f"{el.name}: no free {direction.value} pad")


def find_unlinked_pad(container: Bin, direction: PadDirection) -> Optional[Pad]:
    """First unlinked pad of the given direction in the container (used by the
    harness to attach its endpoints)."""
    for el in container.iterate_elements():
        pads = el.sink_pads() if direction == PadDirection.SINK else el.src_pads()
        for pad in pads:
            if not pad.is_linked() and pad._ghost_forward is None:
                return pad
    return None
