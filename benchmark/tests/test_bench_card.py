"""On the card: the control at a cell's own size is refused, and the
float32 reference on the card gives the CPU's bytes (a short chunk)."""

import pytest
import torch

from benchlib import ref_fvc, source

pytestmark = pytest.mark.cuda


def _frames(seed, card):
    """Three 1080p frames of the cells' source: pan, objects, grain."""
    return source.pan_pool(1, 3, 1080, 1920, (8, 48), 6, seed, card,
                           (128, 64), [(2, 6), (6, 48), (16, 16)], 1.0)[0]


def test_reference_on_the_card_is_the_cpus(card):
    frames = _frames(5, card)
    assert ref_fvc.encode_chunk(frames, 85, 8, False) == \
        ref_fvc.encode_chunk(frames.cpu(), 85, 8, False)


def test_control_at_cell_size_is_refused(card):
    frames = _frames(6, card)
    assert ref_fvc.encode_chunk(frames, 85, 64, False, torch.bfloat16) != \
        ref_fvc.encode_chunk(frames, 85, 64, False)
