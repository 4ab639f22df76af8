"""The search's XLA gathers (acoustic-score gather, state-record fetch)
against numpy indexing, and a full decode through them against the gold
decoder."""

import numpy as np
import pytest

from asr_decoder_tpu.ops.gather import (batched_table_gather,
                                        fetch_state_records)


@pytest.mark.parametrize("B,V,N", [(4, 256, 512), (1, 9, 40), (8, 2048, 128)])
def test_table_gather_matches_numpy(B, V, N):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((B, V)).astype(np.float32)
    idx = rng.integers(0, V, (B, N)).astype(np.int32)
    want = np.take_along_axis(table, idx, axis=1)
    got = np.asarray(batched_table_gather(table, idx))
    np.testing.assert_array_equal(got, want)


def test_device_decode_matches_gold():
    """Full decode parity through the default gathers."""
    from test_beamsearch import random_decode_graph
    from asr_decoder_tpu.decoder.config import DecoderConfig
    from asr_decoder_tpu.decoder.gold import GoldDecoder
    from asr_decoder_tpu.fst.device_fst import DeviceFst
    from asr_decoder_tpu.ops.beamsearch import TpuBeamSearch

    rng = np.random.default_rng(11)
    fst = random_decode_graph(rng)
    dev = DeviceFst.build(fst, arc_lanes=8)
    i2p = np.arange(9, dtype=np.int32)
    cfg = DecoderConfig(beam=1e9, beam_width=64, arc_lanes=8, max_active=64,
                        min_active=0)
    ll = rng.standard_normal((10, 9)).astype(np.float32) * 3
    gold = GoldDecoder(fst, i2p, cfg).decode(ll)
    search = TpuBeamSearch(dev, i2p, cfg)
    state, init_log, logs = search.decode(ll[None])
    res = search.traceback(state, init_log, logs, fst)[0]
    assert res["cost"] == pytest.approx(gold.cost, abs=1e-3)
    if gold.reached_final:
        assert res["words"] == gold.words


@pytest.mark.parametrize("S,L", [(50, 32), (7, 5), (1000, 37)])
def test_state_record_fetch_matches_numpy(S, L):
    """Odd record widths gather whole rows unchanged."""
    rng = np.random.default_rng(1)
    records = rng.integers(-2**31, 2**31 - 1, (S, L), dtype=np.int64
                           ).astype(np.int32)
    state = rng.integers(0, S, (3, 16)).astype(np.int32)
    got = np.asarray(fetch_state_records(records, state))
    np.testing.assert_array_equal(got, records[state])


def test_state_record_fetch_dead_slots_read_row_zero():
    """Dead slots (state −1) read row 0, never out of bounds."""
    records = np.arange(6 * 4, dtype=np.int32).reshape(6, 4)
    state = np.array([[5, -1, 2, -1], [-1, -1, -1, -1]], np.int32)
    got = np.asarray(fetch_state_records(records, state))
    assert got.shape == (2, 4, 4)
    np.testing.assert_array_equal(got, records[np.maximum(state, 0)])
    np.testing.assert_array_equal(got[1], np.broadcast_to(records[0], (4, 4)))
