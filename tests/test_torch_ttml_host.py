"""The host TTML layers of flutpu_torch (parse engine, timeline, the
``ttmlparse`` and ``ttmlsegmentedparse`` elements, layout) against their
originals in flutpu. They are carried as copies (the port imports nothing
of flutpu): each copy's source equals its original's, and on every
document of tests/ttml_corpus the two packages' elements emit the same
intervals with the same bytes."""

import inspect

import numpy as np
import pytest
import torch

import flutpu.core as j_core
import flutpu.ttml as j_ttml
import flutpu_torch.core as t_core
import flutpu_torch.ttml as t_ttml
from flutpu.core import Buffer as JBuffer
from flutpu.core import Harness as JHarness
from flutpu_torch.core import Buffer as TBuffer
from flutpu_torch.core import Harness as THarness
from flutpu_torch.core import registry as t_registry
from torch_helpers import corpus_docs, run_element

torch.set_num_threads(1)

COPIES = ["enums", "namespace", "attributes", "style", "span", "state",
          "timeline", "base", "parse_el", "segmented", "typefind",
          "render.layout"]
AREAS = sorted({k.split("/")[0] for k, _ in corpus_docs()})


def _module(pkg, name):
    import importlib
    return importlib.import_module(f"{pkg.__name__}.{name}")


@pytest.mark.parametrize("name", COPIES)
def test_copied_module_source_equals_original(name):
    assert inspect.getsource(_module(t_ttml, name)) == \
        inspect.getsource(_module(j_ttml, name))


def test_fonts_copy_differs_only_in_the_fallbacks():
    """fonts.py keeps flutpu's shaping where the DejaVu files are found:
    the family table, the metrics and the PIL drawing are the original's
    lines; the additions are the built-in font at the asked size and the
    bitmap font."""
    j = inspect.getsource(_module(j_ttml, "render.fonts")).splitlines()
    t = inspect.getsource(_module(t_ttml, "render.fonts")).splitlines()
    missing = [ln for ln in j if ln.strip() and ln not in t]
    # flutpu's lines that the port rewrote: the module docstring's first
    # line, load_font's docstring and its fixed-size default font, the
    # unconditional PIL import of rasterize_run
    assert len(missing) <= 12, missing
    from flutpu.ttml.render import fonts as jf
    from flutpu_torch.ttml.render import fonts as tf
    assert tf._FAMILY_FILES == jf._FAMILY_FILES
    for args in (("Hello", "default", 24), ("x y", "serif", 17, True, True),
                 ("lean", "monospace", 30, False, False)):
        assert vars(tf.measure_run(*args)) == vars(jf.measure_run(*args))
        (a, ma), (b, mb) = tf.rasterize_run(*args), jf.rasterize_run(*args)
        np.testing.assert_array_equal(a, b)
        assert vars(ma) == vars(mb)
    a, _ = tf.rasterize_run("lean", "default", 24, shear=-0.21)
    b, _ = jf.rasterize_run("lean", "default", 24, shear=-0.21)
    np.testing.assert_array_equal(a, b)


def test_registry_loads_the_ttml_elements():
    have = t_registry.factories()
    for name in ("ttmlparse", "ttmlsegmentedparse", "cudattmlrender",
                 "cudaoverlaycompositor"):
        assert name in have
        assert have[name].__module__.startswith("flutpu_torch.ttml")
    assert "ttmlrender" not in have and "overlaycompositor" not in have


def _texts(out):
    return [(p, d, bytes(x)) for p, d, x in out]


@pytest.mark.parametrize("element", ["ttmlparse", "ttmlsegmentedparse"])
@pytest.mark.parametrize("area", AREAS)
def test_corpus_element_output_equal(area, element):
    docs = [(k, d) for k, d in corpus_docs() if k.startswith(area + "/")]
    assert docs
    n = 0
    for key, doc in docs:
        want = _texts(run_element(JHarness, JBuffer, element, doc))
        got = _texts(run_element(THarness, TBuffer, element, doc))
        assert got == want, key
        n += len(got)
    assert n > 0


def _attr(a):
    return None if a is None else (a.type.name, repr(a.value), a.raw)


def _style(st):
    return None if st is None else [_attr(a) for a in st]


def _timeline_of(core, doc):
    """Every event the parse engine puts on its timeline for ``doc``, in
    insertion order, as plain tuples (the two packages' classes are
    distinct objects)."""
    el = core.make("ttmlparse")
    h = core.Harness(el)
    h.set_src_caps("application/ttml+xml")
    events = []
    insert = el.timeline.insert

    def record(ev):
        if ev is not None:
            span = ev.span and (ev.span.span_id, ev.span.chars,
                                ev.span.region_id, _style(ev.span.style))
            events.append((ev.timestamp, ev.type.value, span, ev.span_id,
                           _attr(ev.attr), ev.region_id, _style(ev.style)))
        insert(ev)

    el.timeline.insert = record
    h.push(core.Buffer(doc.encode(), pts=0))
    h.push_eos()
    h.teardown()
    return events


@pytest.mark.parametrize("area", AREAS)
def test_corpus_timelines_and_spans_equal(area):
    """The parse engine below the elements: the same timeline events
    (time, type, span text, region and style, attribute updates) for
    every document."""
    n = 0
    for key, doc in corpus_docs():
        if not key.startswith(area + "/"):
            continue
        want = _timeline_of(j_core, doc)
        assert _timeline_of(t_core, doc) == want, key
        n += len(want)
    assert n > 0
