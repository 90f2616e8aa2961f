"""The TTML renderer's device half in flutpu_torch (atlas, instance
compositor, window compositor, stroke filter, the ``cudattmlrender`` and
``cudaoverlaycompositor`` elements) against flutpu's on the CPU.

Contract: the compositors do flutpu's float32 arithmetic on the same
pixels in the same order, so BGRA windows are equal pixel for pixel — on
seeded tiles and instance tables (fractional opacities, clamped
placements, padding instances, image tiles included) and on every test
document, through every engine. No document here breaks it (a sweep of
all of tests/ttml_corpus, ``FLUTPU_FULL_CORPUS=1``, found none either),
so no tie allowance is taken. The stroke filter ends in a truncating cast
after two blurs whose summation order differs (XLA's convolution against
a fixed-order sum): its tiles are held to ±1 level. ``scale_bilinear`` is
held to 1e-3 of a level."""

import base64
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flutpu.core as j_core
import flutpu_torch.core as t_core
from flutpu.codec.ops.colorspace import scale_bilinear as j_scale
from flutpu.ttml.render import atlas as j_atlas
from flutpu.ttml.render import composite as j_comp
from flutpu.ttml.render import device as j_dev
from flutpu_torch.codec.ops.colorspace import scale_bilinear
from flutpu_torch.ttml.render import atlas as t_atlas
from flutpu_torch.ttml.render import composite as t_comp
from flutpu_torch.ttml.render import device as t_dev
from flutpu_torch.ttml.render import fonts as t_fonts
from chip_smoke import Loopback
from torch_helpers import corpus_docs, run_element

torch.set_num_threads(1)

TILE_H, TILE_W = t_atlas.TILE_H, t_atlas.TILE_W


# -- seeded tiles and instance tables ---------------------------------------------

def _tiles(rng, n, img=0):
    tiles = [np.full((TILE_H, TILE_W), 255, np.uint8)] + [
        rng.integers(0, 256, (TILE_H, TILE_W), np.uint8)
        for _ in range(n - 1)]
    imgs = [np.zeros((TILE_H, TILE_W, 4), np.uint8)] + [
        rng.integers(0, 256, (TILE_H, TILE_W, 4), np.uint8)
        for _ in range(img)]
    return tiles, imgs


def _table(rng, n, cap, n_tiles, h, w, n_img=0):
    """``n`` random instances padded to ``cap`` with no-op ones: starts up
    to a tile outside the window, clip rects that cut, opacities 1, 0.5
    (coverage 255 then lands on the rounding tie 127.5) and random."""
    ints = np.zeros((cap, 9), np.int32)
    cols = np.zeros((cap, 4), np.float32)
    for i in range(n):
        tile = int(rng.integers(0, n_tiles))
        if n_img and rng.random() < 0.3:
            tile = -int(rng.integers(1, n_img + 1)) - 1
        ints[i] = (tile, rng.integers(-TILE_W, w), rng.integers(-TILE_H, h),
                   rng.integers(1, TILE_W + 1), rng.integers(1, TILE_H + 1),
                   rng.integers(-20, w // 2), rng.integers(-20, h // 2),
                   rng.integers(w // 2, w + 30), rng.integers(h // 2, h + 30))
        cols[i] = (*rng.random(3), rng.choice([1.0, 0.5, rng.random()]))
    return ints, cols


def _j_atlas(tiles):
    return jnp.asarray(np.stack(tiles))


@pytest.mark.parametrize("seed,h,w", [(0, 64, 96), (1, 192, 320),
                                      (2, 100, 130)])
def test_composite_instances_pixel_identical(seed, h, w):
    rng = np.random.default_rng(seed)
    tiles, _ = _tiles(rng, 6)
    ints, cols = _table(rng, 13, 16, 6, h, w)
    want = np.asarray(j_dev.composite_instances(
        _j_atlas(tiles), jnp.asarray(ints), jnp.asarray(cols), window_h=h,
        window_w=w))
    atlas = t_atlas.atlas_from_numpy(tiles, device="cpu")
    got = t_dev.composite_instances(atlas.device_array(), ints, cols, h, w)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[..., 3] > 0).any()


def test_composite_instances_with_image_tiles_pixel_identical():
    rng = np.random.default_rng(3)
    tiles, imgs = _tiles(rng, 4, img=3)
    ints, cols = _table(rng, 11, 16, 4, 96, 160, n_img=3)
    assert (ints[:, 0] < 0).any()
    want = np.asarray(j_dev.composite_instances(
        _j_atlas(tiles), jnp.asarray(ints), jnp.asarray(cols), window_h=96,
        window_w=160, imgatlas=jnp.asarray(np.stack(imgs))))
    atlas = t_atlas.atlas_from_numpy(tiles, imgs, device="cpu")
    got = t_dev.composite_instances(
        atlas.device_array(), ints, cols, 96, 160,
        imgatlas=atlas.image_device_array())
    np.testing.assert_array_equal(got.numpy(), want)


def test_half_opacity_tie_lands_where_flutpus_does():
    """col_a = 0.5 on coverage 255: out_a * 255 + 0.5 is exactly 128."""
    tiles = [np.full((TILE_H, TILE_W), 255, np.uint8)]
    ints = np.array([[0, 0, 0, 40, 20, 0, 0, 64, 32]], np.int32)
    cols = np.array([[1.0, 0.25, 0.5, 0.5]], np.float32)
    want = np.asarray(j_dev.composite_instances(
        _j_atlas(tiles), jnp.asarray(ints), jnp.asarray(cols), window_h=32,
        window_w=64))
    got = t_dev.composite_instances(
        t_atlas.atlas_from_numpy(tiles, device="cpu").device_array(), ints,
        cols, 32, 64).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[5, 5, 3] == 128 and got[25, 50, 3] == 0


@pytest.mark.parametrize("unstack", [False, True])
def test_composite_instances_batch_pixel_identical(unstack):
    rng = np.random.default_rng(4)
    tiles, _ = _tiles(rng, 5)
    tabs = [_table(rng, n, 8, 5, 80, 120) for n in (7, 3, 0)]
    ints = np.stack([t[0] for t in tabs])
    cols = np.stack([t[1] for t in tabs])
    want = j_dev.composite_instances_batch(
        _j_atlas(tiles), jnp.asarray(ints), jnp.asarray(cols), window_h=80,
        window_w=120, unstack=unstack)
    got = t_dev.composite_instances_batch(
        t_atlas.atlas_from_numpy(tiles, device="cpu").device_array(), ints,
        cols, 80, 120, unstack=unstack)
    assert isinstance(got, tuple) == unstack and len(got) == 3
    for a, c in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert not got[2].any()              # the all-padding interval is blank


def _vmap_case():
    """``test_ttml_render.py``'s case for flutpu's vmap variant: 8 seeded
    tiles, 5 intervals of 6 instances at clamped and partial placements,
    fractional colours and opacities, a 200 x 120 window."""
    rng = np.random.default_rng(7)
    atlas = rng.integers(0, 255, (8, TILE_H, TILE_W)).astype(np.uint8)
    k, n, w, h = 5, 6, 200, 120
    ints = np.zeros((k, n, 9), np.int32)
    cols = np.zeros((k, n, 4), np.float32)
    for kk in range(k):
        for i in range(n):
            x = int(rng.integers(-16, w - 10))
            y = int(rng.integers(-16, h - 10))
            iw = int(rng.integers(4, TILE_W))
            ih = int(rng.integers(4, TILE_H))
            ints[kk, i] = (int(rng.integers(0, 8)), x, y, iw, ih,
                           x, y, x + iw, y + ih)
            cols[kk, i] = (*rng.random(3), float(rng.random()))
    return atlas, ints, cols, h, w


def _solid_case():
    """``test_ttml_render.py``'s unstack case: a solid tile at three
    placements of 3 intervals, a padding instance each."""
    atlas = np.full((2, TILE_H, TILE_W), 255, np.uint8)
    ints = np.zeros((3, 2, 9), np.int32)
    cols = np.zeros((3, 2, 4), np.float32)
    for kk in range(3):
        ints[kk, 0] = (1, 10 * kk, 5, 40, 20, 0, 0, 200, 100)
        cols[kk, 0] = (1.0, 0.5, 0.25, 1.0)
    return atlas, ints, cols, 100, 200


@pytest.mark.parametrize("case", [_vmap_case, _solid_case],
                         ids=["seeded", "solid"])
@pytest.mark.parametrize("unstack", [False, True])
def test_composite_instances_batch_vmap_pixel_identical(case, unstack):
    """The batched-interval variant (item 8): every interval's instance
    i blended in one step. Its windows = flutpu's
    ``composite_instances_batch_vmap`` and the port's
    ``composite_instances_batch``, pixel for pixel; ``unstack`` hands
    back a K-tuple of the same windows."""
    atlas, ints, cols, h, w = case()
    want = np.asarray(j_dev.composite_instances_batch_vmap(
        jnp.asarray(atlas), jnp.asarray(ints), jnp.asarray(cols),
        window_h=h, window_w=w))
    got = t_dev.composite_instances_batch_vmap(
        torch.from_numpy(atlas), ints, cols, h, w, unstack=unstack)
    seq = t_dev.composite_instances_batch(torch.from_numpy(atlas), ints,
                                          cols, h, w)
    if unstack:
        assert isinstance(got, tuple) and len(got) == len(ints)
        got = torch.stack(got)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, seq)


def test_composite_instances_over_pixel_identical():
    rng = np.random.default_rng(5)
    tiles, _ = _tiles(rng, 4)
    ints, cols = _table(rng, 6, 8, 4, 72, 104)
    base = rng.integers(0, 256, (72, 104, 4), np.uint8)
    base[:20] = 0
    want = np.asarray(j_dev.composite_instances_over(
        _j_atlas(tiles), jnp.asarray(ints), jnp.asarray(cols),
        jnp.asarray(base), window_h=72, window_w=104))
    got = t_dev.composite_instances_over(
        t_atlas.atlas_from_numpy(tiles, device="cpu").device_array(), ints,
        cols, torch.from_numpy(base), 72, 104)
    np.testing.assert_array_equal(got.numpy(), want)


def test_instance_list_and_padding_equal_flutpus():
    def build(mod):
        inst = mod.InstanceList()
        e = type("E", (), {"tiles": [(3, 0, 0, 512, 30), (4, 512, 0, 90, 30)]})
        inst.add_entry(e, -40, 50, (255, 128, 0, 200), 0.5, (0, 0, 300, 200))
        inst.add_rect(10, -300, 700, 150, (1, 2, 3, 255), 1.0,
                      (0, 0, 300, 200))
        inst.add_tile(2, 5000, 5, 10, 10, (9, 9, 9, 255), 1.0, (0, 0, 1, 1))
        inst.add_tile(2, 5, 5, 10, 10, (9, 9, 9, 0), 1.0, (0, 0, 1, 1))
        return inst.arrays(200, 300) + mod.pad_instances([], [], cap=4)
    for a, c in zip(build(t_dev), build(j_dev)):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(a, c)


def test_compose_window_pixel_identical():
    rng = np.random.default_rng(6)
    layers = rng.integers(0, 256, (3, 40, 56, 4), np.uint8)
    layers[0, :10] = 0
    boxes = np.zeros((3, 4), np.int32)
    ops = np.array([1.0, 0.5, 0.3], np.float32)
    want = np.asarray(j_comp.compose_window(
        jnp.asarray(layers), jnp.asarray(boxes), jnp.asarray(ops),
        window_h=40, window_w=56))
    got = t_comp.compose_window(torch.from_numpy(layers),
                                torch.from_numpy(boxes),
                                torch.from_numpy(ops), 40, 56)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("radius,blur", [(1, 0), (2, 1), (2, 3), (0, 2),
                                         (3, 4)])
def test_stroke_tiles_within_one_level(radius, blur):
    """Glyph-like tiles (a rasterized run and random blobs). Without a
    blur the dilation is exact; with one, the truncating cast after sums
    in two different orders may land one level apart."""
    rng = np.random.default_rng(7)
    run, _ = t_fonts.rasterize_run("Stroke me", "default", 40)
    tiles = np.zeros((3, TILE_H, TILE_W), np.uint8)
    tiles[0, :run.shape[0], :run.shape[1]] = run[:TILE_H, :TILE_W]
    tiles[1, 30:90, 100:400] = rng.integers(0, 256, (60, 300), np.uint8)
    tiles[2] = rng.integers(0, 256, (TILE_H, TILE_W), np.uint8)
    want = np.asarray(j_atlas._stroke_tiles(jnp.asarray(tiles),
                                            radius=radius, blur_px=blur))
    got = t_atlas._stroke_tiles(torch.from_numpy(tiles), radius, blur)
    assert got.dtype == torch.uint8
    d = np.abs(got.numpy().astype(int) - want.astype(int))
    if blur == 0:
        assert d.max() == 0
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 0.02, (d > 0).mean()


@pytest.mark.parametrize("shape,out", [((20, 30, 4), (48, 64)),
                                       ((48, 64, 4), (20, 30)),
                                       ((33, 47), (33, 90))])
def test_scale_bilinear_matches_flutpu(shape, out):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, shape, np.uint8)
    want = np.asarray(j_scale(jnp.asarray(img), *out))
    got = scale_bilinear(torch.from_numpy(img), *out)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


# -- the atlas ---------------------------------------------------------------------

def test_atlas_from_numpy_carries_flutpus_tiles():
    ja = j_atlas.GlyphAtlas()
    e = ja.run_entry("Carried over", "default", 28, False, False)
    ja.image_entry(np.full((10, 12, 4), 77, np.uint8))
    ta = t_atlas.atlas_from_numpy(ja._tiles, ja._img_tiles, device="cpu")
    np.testing.assert_array_equal(ta.device_array().numpy()[:len(ja._tiles)],
                                  np.asarray(ja.device_array())
                                  [:len(ja._tiles)])
    np.testing.assert_array_equal(
        ta.image_device_array().numpy()[:2],
        np.asarray(ja.image_device_array())[:2])
    assert ta.device_array().shape[0] == 16 and e.tiles[0][0] == 1
    with pytest.raises(ValueError):
        t_atlas.atlas_from_numpy([np.zeros((4, 4), np.uint8)], device="cpu")


def test_atlas_uploads_new_tiles_and_grows():
    a = t_atlas.GlyphAtlas("cpu")
    first = a.device_array()
    assert first.shape == (16, TILE_H, TILE_W) and first[0].min() == 255
    e = a.run_entry("grow", "default", 20, False, False)
    second = a.device_array()
    assert second.data_ptr() == first.data_ptr()      # same tensor, one
    idx = e.tiles[0][0]                               # more tile uploaded
    np.testing.assert_array_equal(second[idx].numpy(), a._tiles[idx])
    for i in range(20):
        a.run_entry(f"run {i}", "default", 20, False, False)
    third = a.device_array()
    assert third.shape[0] == 32
    for i, t in enumerate(a._tiles):
        np.testing.assert_array_equal(third[i].numpy(), t)
    assert not third[len(a._tiles):].any()


def test_stroked_entry_caches_and_matches_flutpu():
    ta, ja = t_atlas.GlyphAtlas("cpu"), j_atlas.GlyphAtlas()
    args = ("Outline", "default", 32, False, False, 2, 1)
    et, ej = ta.stroked_entry(*args), ja.stroked_entry(*args)
    assert et.tiles == ej.tiles and ta.stroked_entry(*args) is et
    for (i, *_), (j, *_) in zip(et.tiles, ej.tiles):
        d = np.abs(ta._tiles[i].astype(int) - ja._tiles[j].astype(int))
        assert d.max() <= 1


def test_one_atlas_per_device():
    a = t_atlas.get_atlas("cpu")
    assert t_atlas.get_atlas(torch.device("cpu")) is a
    assert a.device == torch.device("cpu")
    assert a.device_array().device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            t_atlas.get_atlas("cuda")     # names the card, or raises


# -- the elements ---------------------------------------------------------------------

DOC_BASIC = """<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml" xmlns:tts="http://www.w3.org/ns/ttml#styling">
  <body><div>
    <p begin="0s" end="2s" tts:color="yellow">Hello</p>
  </div></body>
</tt>
"""

DOC_REGION = """<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml" xmlns:tts="http://www.w3.org/ns/ttml#styling">
  <head><layout>
    <region xml:id="r1" tts:origin="0% 0%" tts:extent="50% 25%"
            tts:backgroundColor="blue"/>
    <region xml:id="r2" tts:origin="50% 75%" tts:extent="50% 25%"
            tts:backgroundColor="red" tts:showBackground="always"/>
  </layout></head>
  <body><div>
    <p begin="0s" end="2s" region="r1" tts:color="white">Top left</p>
  </div></body>
</tt>
"""

DOC_OUTLINE = DOC_BASIC.replace(
    'tts:color="yellow"', 'tts:color="white" tts:textOutline="black 2px 1px" '
    'tts:textDecoration="underline"')

DOC_BATCH = """<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml" xmlns:tts="http://www.w3.org/ns/ttml#styling">
  <head><layout>
    <region xml:id="r" tts:origin="5% 70%" tts:extent="90% 25%"
            tts:backgroundColor="#00000080" tts:opacity="0.7"/>
  </layout></head>
  <body><div>
    <p begin="0s" end="1s" region="r" tts:color="white">first cue</p>
    <p begin="1s" end="2s" region="r" tts:color="yellow">second cue</p>
    <p begin="3s" end="4s" region="r"
       tts:textOutline="black 2px">fourth, after a gap</p>
  </div></body>
</tt>"""

DOC_VERTICAL = """<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml" xmlns:tts="http://www.w3.org/ns/ttml#styling">
  <head><layout>
    <region xml:id="v" tts:origin="10% 10%" tts:extent="30% 80%"
            tts:writingMode="tbrl" tts:backgroundColor="navy"/>
    <region xml:id="v2" tts:origin="55% 10%" tts:extent="30% 80%"
            tts:writingMode="tblr" tts:backgroundColor="maroon"/>
  </layout></head>
  <body><div>
    <p begin="0s" end="1s" region="v" tts:color="white">vertical</p>
    <p begin="0s" end="1s" region="v2" tts:color="yellow">other way</p>
  </div></body>
</tt>"""

DOC_REVOBLIQUE = DOC_BASIC.replace('tts:color="yellow"',
                                   'tts:fontStyle="reverseOblique"')

DOC_PAR = DOC_BASIC.replace(
    'xmlns:tts=', 'xmlns:ttp="http://www.w3.org/ns/ttml#parameter" '
    'ttp:pixelAspectRatio="2 1" xmlns:tts=')


def _doc_image(ref="#img1"):
    from PIL import Image
    buf = io.BytesIO()
    Image.new("RGBA", (24, 16), (0, 200, 40, 255)).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    return f"""<?xml version="1.0"?>
<tt xmlns="http://www.w3.org/ns/ttml" xmlns:tts="http://www.w3.org/ns/ttml#styling"
    xmlns:smpte="http://www.smpte-ra.org/schemas/2052-1/2010/smpte-tt">
  <head>
    <metadata>
      <smpte:image xml:id="img1" imagetype="PNG" encoding="Base64">{b64}</smpte:image>
    </metadata>
    <layout>
      <region xml:id="r1" tts:origin="5% 5%" tts:extent="60% 60%"
              smpte:backgroundImage="{ref}"/>
    </layout>
  </head>
  <body><div>
    <p begin="0s" end="1s" region="r1" tts:color="white">on image</p>
  </div></body>
</tt>"""


DOCS = {"basic": DOC_BASIC, "region": DOC_REGION, "outline": DOC_OUTLINE,
        "batch": DOC_BATCH, "vertical": DOC_VERTICAL,
        "reverse-oblique": DOC_REVOBLIQUE, "par": DOC_PAR,
        "image": _doc_image()}


def _render(core, factory, doc, props="", w=320, h=192):
    out = run_element(core.Harness, core.Buffer,
                      f"{factory} window-width={w} window-height={h} {props}",
                      doc)
    return [(p, d, np.asarray(x)) for p, d, x in out]


def _port(doc, props="", **kw):
    return _render(t_core, "cudattmlrender", doc, props + " device=cpu", **kw)


def _assert_same_windows(got, want, label):
    assert len(got) == len(want) and want, label
    for i, ((pa, da, fa), (pb, db, fb)) in enumerate(zip(got, want)):
        assert (pa, da) == (pb, db), (label, i)
        assert fa.dtype == np.uint8 and fa.shape == fb.shape, (label, i)
        bad = np.argwhere(fa != fb)
        assert not len(bad), (label, i, bad[:4].tolist())


@pytest.mark.parametrize("engine", ["atlas", "layers", "host"])
@pytest.mark.parametrize("name", sorted(DOCS))
def test_element_windows_pixel_identical(name, engine):
    props = f"render-engine={engine}"
    want = _render(j_core, "ttmlrender", DOCS[name], props)
    got = _port(DOCS[name], props)
    _assert_same_windows(got, want, f"{name}/{engine}")
    assert any((f[..., 3] > 0).any() for _, _, f in got)


_SAMPLE = ["Animation/Animation001", "Animation/Animation009",
           "Content/Span004", "Content/Div001", "Styling/ZIndex001",
           "Styling/WritingMode001", "Styling/TextOutline001",
           "Styling/Opacity001", "Styling/Padding002",
           "Parameters/CellResolution001", "Timing/Sequence001",
           "EbuTtD/EbuTtD002"]
_CORPUS = dict(corpus_docs())
_KEYS = sorted(_CORPUS) if os.environ.get("FLUTPU_FULL_CORPUS") else _SAMPLE


@pytest.mark.parametrize("key", _KEYS)
def test_corpus_windows_pixel_identical(key):
    want = _render(j_core, "ttmlrender", _CORPUS[key])
    _assert_same_windows(_port(_CORPUS[key]), want, key)


def test_batched_equals_unbatched():
    a = _port(DOC_BATCH, "batch-intervals=true")
    b = _port(DOC_BATCH, "batch-intervals=false")
    assert len(a) >= 4
    _assert_same_windows(a, b, "batch")
    _assert_same_windows(a, _render(j_core, "ttmlrender", DOC_BATCH,
                                    "batch-intervals=false"), "batch vs jax")


def test_crop_delivery_equals_full_window():
    a = _port(DOC_BATCH, "crop-delivery=true")
    b = _port(DOC_BATCH, "crop-delivery=false")
    _assert_same_windows(a, b, "crop")
    ints = np.array([[[0, 20, 130, 100, 30, 16, 134, 304, 182]]], np.int32)
    from flutpu.ttml.render.render_el import TTMLRender as JRender
    from flutpu_torch.ttml.render.render_el import TTMLRender
    assert TTMLRender._union_bbox(ints, 320, 192) == \
        JRender._union_bbox(ints, 320, 192) != None  # noqa: E711


def test_padding_intervals_are_not_composited(monkeypatch):
    """flutpu pads a batch to a multiple of 4 intervals and discards the
    padding's frames; the port composites the 5 real intervals only, and
    delivers the same windows (test_batched_equals_unbatched)."""
    from flutpu_torch.ttml.render import render_el
    seen = []
    orig = render_el.composite_instances_batch

    def spy(atlas, ints, cols, **kw):
        seen.append(len(ints))
        return orig(atlas, ints, cols, **kw)

    monkeypatch.setattr(render_el, "composite_instances_batch", spy)
    out = _port(DOC_BATCH)
    assert seen == [len(out)] and len(out) % 4


def test_device_out_hands_over_tensors():
    out = run_element(t_core.Harness, t_core.Buffer,
                      "cudattmlrender window-width=96 window-height=64 "
                      "device=cpu device-out=true", DOC_BATCH)
    host = _port(DOC_BATCH, w=96, h=64)
    assert len(out) == len(host) >= 4
    for (_, _, t), (_, _, a) in zip(out, host):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8
        np.testing.assert_array_equal(t.numpy(), a)
    for engine in ("layers", "host"):
        (_, _, t), *_ = run_element(
            t_core.Harness, t_core.Buffer, "cudattmlrender window-width=96 "
            f"window-height=64 device=cpu device-out=true "
            f"render-engine={engine} batch-intervals=false", DOC_BASIC)
        assert isinstance(t, torch.Tensor)


def test_url_background_image_raises():
    """A URL background image no longer raises: it is fetched through the
    port's downloader (here from a loopback server), and the window
    equals the same document with the image embedded as ``#img1`` and
    flutpu's ``ttmlrender`` of the URL document, pixel for pixel. A URL
    that cannot be fetched, and a missing ``#id``, draw no image."""
    from flutpu_torch.ttml.render.render_el import TTMLRender
    png = base64.b64decode(_doc_image().split('encoding="Base64">')[1]
                           .split("<")[0])
    with Loopback({"/img.png": png}) as srv:
        doc = _doc_image(srv.url("/img.png"))
        got = _port(doc)
        _assert_same_windows(got, _port(_doc_image()), "url vs #id")
        _assert_same_windows(got, _render(j_core, "ttmlrender", doc),
                             "url vs flutpu")
        el = TTMLRender(device="cpu")
        img = el._fetch_image(srv.url("/img.png"))
        assert img.shape == (16, 24, 4) and (img[..., 1] == 200).all()
        assert el._fetch_image(srv.url("/missing.png")) is None
    assert el._fetch_image("#missing") is None


def test_device_defaults_to_the_card():
    from flutpu_torch.ttml.render.overlay_el import OverlayCompositor
    from flutpu_torch.ttml.render.render_el import TTMLRender
    assert str(TTMLRender().get_property("device")) == "cuda"
    assert str(OverlayCompositor().get_property("device")) == "cuda"
    assert t_atlas.GlyphAtlas().device.type == "cuda"


# -- the burn-in pipeline ------------------------------------------------------------

_SUB = ("<?xml version='1.0'?><tt xmlns='http://www.w3.org/ns/ttml' "
        "xmlns:tts='http://www.w3.org/ns/ttml#styling'><body><div>"
        "<p begin='0s' end='1s' tts:backgroundColor='red'>SUBTITLES</p>"
        "</div></body></tt>")


def _burnin(core, render, comp, frames, window=(96, 64)):
    p = core.parse_launch(
        "appsrc name=vsrc caps='video/x-raw, format=RGB, width=96, "
        "height=64, framerate=30/1' ! comp.video "
        "appsrc name=ssrc caps='application/ttml+xml' "
        f"! {render} window-width={window[0]} window-height={window[1]} "
        f"! comp.overlay {comp} name=comp ! appsink name=out")
    vsrc, ssrc, sink = (p.get_by_name(x) for x in ("vsrc", "ssrc", "out"))
    assert p.play().name == "SUCCESS"
    ssrc.push(core.Buffer(_SUB.encode(), pts=0))
    ssrc.end_of_stream()
    for pts, frame in frames:
        vsrc.push(core.Buffer(frame, pts=pts, duration=core.MSECOND))
    vsrc.end_of_stream()
    out = [sink.try_pull_buffer(timeout=30) for _ in frames]
    p.stop()
    return [np.asarray(b.data) for b in out]


@pytest.mark.parametrize("device_out", ["false", "true"])
def test_burnin_pipeline_equals_flutpus(device_out):
    """The element graph of BASELINE config 5 (tests/test_ttml_render.py
    ``test_burnin_pipeline``): frames inside the cue carry it, frames past
    it pass through; the port's frames equal flutpu's."""
    from flutpu.core.elements import make_test_frame
    S = j_core.SECOND
    frames = [(int(0.5 * S), np.zeros((64, 96, 3), np.uint8)),
              (int(0.7 * S), make_test_frame("gradient", 96, 64, 3)),
              (5 * S, np.zeros((64, 96, 3), np.uint8))]
    want = _burnin(j_core, "ttmlrender", "overlaycompositor", frames)
    got = _burnin(t_core, f"cudattmlrender device=cpu device-out={device_out}",
                  "cudaoverlaycompositor device=cpu", frames)
    for a, c in zip(got, want):
        np.testing.assert_array_equal(a, c)
    assert (got[0][..., 0] > 100).sum() > 10 and (got[2] == 0).all()


def test_burnin_pipeline_scales_a_mismatched_overlay():
    """A window of another size than the video is scaled first
    (``scale_bilinear``): within one level of flutpu's frames."""
    S = j_core.SECOND
    frames = [(int(0.5 * S), np.full((64, 96, 3), 40, np.uint8))]
    want = _burnin(j_core, "ttmlrender", "overlaycompositor", frames,
                   window=(192, 128))
    got = _burnin(t_core, "cudattmlrender device=cpu",
                  "cudaoverlaycompositor device=cpu", frames,
                  window=(192, 128))
    d = np.abs(got[0].astype(int) - want[0].astype(int))
    assert d.max() <= 1 and (got[0][..., 0] > 100).sum() > 10


def test_overlay_compositor_prunes_expired_overlays():
    comp = t_core.make("cudaoverlaycompositor", device="cpu")
    ov = np.zeros((8, 8, 4), np.uint8)
    ov[..., 3] = 9
    S = t_core.SECOND
    for i in range(10):
        comp._overlay_chain(comp.overlay_pad, t_core.Buffer(
            ov, pts=i * S, duration=S))
    assert len(comp._overlays) == 10
    assert comp._active_overlay(9 * S + S // 2) is not None
    assert len(comp._overlays) == 1
    assert comp._active_overlay(100 * S) is None and not comp._overlays
    # a fully transparent overlay is an interval with nothing to burn in
    comp._overlay_chain(comp.overlay_pad, t_core.Buffer(
        np.zeros((8, 8, 4), np.uint8), pts=0, duration=S))
    assert comp._active_overlay(S // 2) is None


# -- the font backends ----------------------------------------------------------------

@pytest.fixture
def fresh_font_caches():
    t_fonts.load_font.cache_clear()
    t_fonts.rasterize_run.cache_clear()
    yield
    t_fonts.load_font.cache_clear()
    t_fonts.rasterize_run.cache_clear()


def test_bitmap_font_where_pil_cannot_be_imported(monkeypatch,
                                                  fresh_font_caches):
    import sys
    assert t_fonts.font_backend() == "PIL (DejaVu)"
    t_fonts.load_font.cache_clear()
    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, mod, None)
    assert t_fonts.font_backend() == "bitmap"
    m = t_fonts.measure_run("Hi there", "default", 30)
    assert (m.width, m.ascent, m.descent) == (64, 24, 6)
    alpha, m2 = t_fonts.rasterize_run("Hi there", "default", 30)
    assert alpha.shape == (m.height, m.width) and alpha.dtype == np.uint8
    assert vars(m2) == vars(m) and set(np.unique(alpha)) == {0, 255}
    assert alpha[:, :8].any() and not alpha[:, 16:24].any()   # 'H', ' '
    # outside printable ASCII: drawn as '?'
    q, _ = t_fonts.rasterize_run("é", "default", 30)
    np.testing.assert_array_equal(
        q, t_fonts.rasterize_run("?", "default", 30)[0])
    atlas = t_atlas.GlyphAtlas("cpu")
    monkeypatch.setattr(t_atlas, "_atlases", {torch.device("cpu"): atlas})
    (_, _, frame), *_ = _port(DOC_BASIC)
    assert (frame[..., 3] > 0).sum() > 50


def test_builtin_font_at_the_asked_size_without_dejavu(monkeypatch,
                                                       fresh_font_caches):
    monkeypatch.setattr(t_fonts, "_font_dir", lambda: None)
    assert t_fonts.font_backend() == "PIL (built-in)"
    small = t_fonts.measure_run("Subtitle", "default", 12)
    large = t_fonts.measure_run("Subtitle", "default", 48)
    assert large.height > 3 * small.height and large.width > 3 * small.width
    alpha, m = t_fonts.rasterize_run("Subtitle", "default", 48)
    assert alpha.shape == (m.height, m.width) and alpha.any()
