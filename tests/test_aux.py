"""Auxiliary subsystems (SURVEY.md §5): transcript tracing (the jet-tracker
analogue), channel-cursor serialization, batch checkpoint/resume."""

import numpy as np

from stark_symphony.models.stwo import channel as stwo_ch
from stark_symphony.utils.checkpoint import (
    BatchCheckpointer,
    channel_state_from_dict,
    channel_state_to_dict,
)
from stark_symphony.utils.trace import (
    format_ops,
    format_transcript,
    record_ops,
    record_transcript,
)


def test_record_transcript_events():
    with record_transcript() as events:
        state = stwo_ch.init()
        state = stwo_ch.mix_root(state, np.arange(8, dtype=np.uint32))
        state, words = stwo_ch.draw_words(state)
    ops = [op for op, _ in events]
    assert ops == ["mix", "draw"]
    text = format_transcript(events)
    assert "mix" in text and "draw" in text
    # digests recorded match the state the channel carries
    np.testing.assert_array_equal(events[0][1], np.asarray(state.digest))
    # no recording outside the context
    state2 = stwo_ch.mix_root(state, np.arange(8, dtype=np.uint32))
    assert len(events) == 2


def test_record_ops_jet_level():
    """Op-level tracing decodes every primitive call with args + result —
    the reference's full jet-tracker depth (tracker.rs:43-63)."""
    from stark_symphony.ops import field as F

    with record_ops() as events:
        a = np.uint32(3)
        b = np.uint32(5)
        out = F.m31_mul(a, b)
        state = stwo_ch.init()
        state = stwo_ch.mix_root(state, np.arange(8, dtype=np.uint32))
    names = [n for n, _, _ in events]
    assert "m31_mul" in names
    assert "sha256_words" in names  # via the channel's direct import
    mul = events[names.index("m31_mul")]
    assert mul[1] == ["0x3", "0x5"] and mul[2] == "0xf"
    text = format_ops(events, limit=1)
    assert "m31_mul" in text and "more" in text
    # originals restored: no recording (and no wrapper) outside the context
    assert F.m31_mul.__name__ == "m31_mul"
    n = len(events)
    F.m31_mul(a, b)
    assert len(events) == n


def test_record_ops_filter():
    from stark_symphony.ops import field as F

    with record_ops({"m31_add"}) as events:
        F.m31_add(np.uint32(1), np.uint32(2))
        F.m31_mul(np.uint32(2), np.uint32(2))
    assert [n for n, _, _ in events] == ["m31_add"]


def test_channel_cursor_roundtrip():
    state = stwo_ch.init()
    state = stwo_ch.mix_root(state, np.arange(8, dtype=np.uint32))
    state, _ = stwo_ch.draw_words(state)
    restored = channel_state_from_dict(channel_state_to_dict(state))
    np.testing.assert_array_equal(np.asarray(state.digest),
                                  np.asarray(restored.digest))
    assert int(np.asarray(state.counter)) == int(np.asarray(restored.counter))
    # the restored cursor continues the transcript identically
    _, w1 = stwo_ch.draw_words(state)
    _, w2 = stwo_ch.draw_words(restored)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))


def test_batch_checkpointer_resume(tmp_path):
    path = tmp_path / "journal.jsonl"
    ckpt = BatchCheckpointer(path)
    ckpt.record(0, np.array([True, True, False, True]))
    ckpt.record(1, np.array([True, True, True, True]))
    assert ckpt.accepted() == 7

    resumed = BatchCheckpointer(path)  # fresh process
    assert resumed.done(0) and resumed.done(1) and not resumed.done(2)
    assert resumed.accepted() == 7 and resumed.batches() == 2
    resumed.record(2, np.array([False] * 4))
    assert resumed.accepted() == 7 and resumed.batches() == 3
