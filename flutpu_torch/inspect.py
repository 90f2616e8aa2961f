"""flutpu_torch-inspect — element discovery (gst-inspect analog; port of
flutpu/inspect.py).

    python -m flutpu_torch.inspect               # list all factories
    python -m flutpu_torch.inspect cudajpegenc   # pads, caps, properties
    python -m flutpu_torch.inspect --markdown    # docs/ELEMENTS_TORCH.md

Listing constructs every element but streams nothing: the port's
elements build their encoders, kernels and device tables on first use,
so inspection initialises no CUDA context and builds no kernel.
"""

from __future__ import annotations

import sys

from .core import factories


def _markdown(regs) -> str:
    """Full element reference as markdown (docs/ELEMENTS_TORCH.md is
    generated from this: ``python -m flutpu_torch.inspect --markdown``)."""
    out = ["# Element reference (flutpu_torch)",
           "",
           "Generated by `python -m flutpu_torch.inspect --markdown` — do "
           "not edit by hand.", ""]
    for name in sorted(regs):
        cls = regs[name]
        out.append(f"## `{name}`")
        out.append("")
        if cls.__doc__:
            out.append(cls.__doc__.strip())
            out.append("")
        try:
            el = cls()
        except Exception:
            el = None
        if el is not None and el.pads:
            out.append("| pad | direction | template caps |")
            out.append("|---|---|---|")
            for pad in el.pads.values():
                caps = pad.template_caps
                desc = "ANY" if caps.is_any else f"`{caps}`"
                out.append(f"| {pad.name} | {pad.direction.value} | {desc} |")
            out.append("")
        specs = cls._all_prop_specs()
        if specs:
            out.append("| property | default | description |")
            out.append("|---|---|---|")
            for spec in specs:
                doc = (spec.doc or "").replace("|", "\\|")
                co = " *(construct-only)*" if spec.construct_only else ""
                out.append(f"| `{spec.name}` | `{spec.default!r}` | "
                           f"{doc}{co} |")
            out.append("")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    regs = factories()
    if args and args[0] == "--markdown":
        print(_markdown(regs), end="")
        return 0
    if not args:
        for name in sorted(regs):
            cls = regs[name]
            doc = (cls.__doc__ or "").strip().splitlines()
            summary = doc[0] if doc else ""
            print(f"{name:24s} {summary[:70]}")
        return 0

    name = args[0]
    if name not in regs:
        print(f"no such element factory {name!r}", file=sys.stderr)
        return 1
    cls = regs[name]
    print(f"Factory: {name}")
    print(f"Class:   {cls.__module__}.{cls.__name__}")
    if cls.__doc__:
        print("\n" + cls.__doc__.strip() + "\n")
    try:
        el = cls()
    except Exception as e:
        print(f"(cannot instantiate for pad listing: {e})")
        el = None
    if el is not None:
        print("Pads:")
        for pad in el.pads.values():
            caps = pad.template_caps
            desc = "ANY" if caps.is_any else repr(caps)
            print(f"  {pad.direction.value:5s} {pad.name:12s} {desc}")
        if el.request_pad.__qualname__ != "Element.request_pad":
            print("  (has request pads)")
    specs = cls._all_prop_specs()
    if specs:
        print("Properties:")
        for spec in specs:
            flags = " [construct-only]" if spec.construct_only else ""
            print(f"  {spec.name:24s} default={spec.default!r}{flags}"
                  f"{'  ' + spec.doc if spec.doc else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
