"""Online (streaming) recognition: feed feature chunks, get partial
transcripts, with carried beam state between feeds.

The reference's recognizer contract is per-frame streaming: the corpus
driver pulls features from Flow and calls `SearchAlgorithm::feed(scores)`
frame by frame, reading partial results via `getCurrentBestSentence` and
the final traceback at segment end
(rwth-asr-0.5/src/Speech/Recognizer.hh:37-110 — OfflineRecognizer's
processFeature → feed; Search/Search.hh:33-72 — restart/feed/
getCurrentBestSentence). The SpeechRecognizer tool exposes this as its
offline/online modes (Tools/SpeechRecognizer/SpeechRecognizer.cc:30-66).

Device shape: per-frame device dispatches would be latency-bound, so
the stream is committed in DECODE_CHUNK-frame slices of the SAME two
compiled programs the offline decoder uses (per-chunk acoustic scoring +
the chunked word-loop scan with carried lattice state,
search/decoder.py). Because offline decoding chunks at identical
boundaries, streaming results are BIT-IDENTICAL to offline decoding of
the same frames — feeds of any size only change when work happens, not
what is computed. `partial()` decodes the not-yet-committed tail from
the committed carry without committing it (the lookahead-free
getCurrentBestSentence).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

import jax.numpy as jnp

from ..models import gmm as gmm_mod
from .decoder import (BIG, DECODE_CHUNK, DecoderTables, _check_pack_bounds,
                      _decode_scan, _decode_scan_df, _pack_traceback,
                      _traceback_host, _unpack_traceback)


class OnlineRecognizer:
    """Streaming decoder over ``num_streams`` parallel feature streams.

    feed(frames)  — append [B, T_any, dim] frames (lockstep across
                    streams; pad short streams and pass their true
                    lengths to finish()/partial()).
    partial()     — current best transcripts over everything fed so far.
    finish()      — final transcripts (identical to the offline
                    decode_batch/decode_batch_df of the same frames).
    restart()     — reset all carried state (SearchAlgorithm::restart).

    Latency: ``chunk_latencies_s`` records the wall time of each
    committed chunk dispatch; ``partial_latencies_s`` of each partial()
    call — the per-feed cost a caller would observe.
    """

    def __init__(self, pack, tables: DecoderTables, am_threshold: float,
                 silence_idx: int, dtype=jnp.float32,
                 num_streams: int = 1, chunk: int = DECODE_CHUNK,
                 prune: bool = True):
        self.pack = pack
        self.tables = tables
        self.silence_idx = silence_idx
        self.num_streams = num_streams
        self.chunk = chunk
        self.prune = prune
        self.is_df = (dtype == "df32")
        self.dtype = jnp.float32 if self.is_df else dtype
        W, P = tables.state_table.shape
        self._W, self._P = W, P
        if self.is_df:
            from ..ops import doublefloat as dfm

            tdp_df = dfm.from_f64(tables.tdp_within)
            ent_df = dfm.from_f64(tables.entry_pen)
            self._args = (jnp.asarray(tables.state_table),
                          jnp.asarray(tables.last_pos),
                          jnp.asarray(tables.word_len),
                          jnp.asarray(tables.first_state),
                          tdp_df.hi, tdp_df.lo, ent_df.hi, ent_df.lo,
                          jnp.asarray(am_threshold, jnp.float32))
        else:
            self._args = (jnp.asarray(tables.state_table),
                          jnp.asarray(tables.last_pos),
                          jnp.asarray(tables.word_len),
                          jnp.asarray(tables.first_state),
                          jnp.asarray(tables.tdp_within),
                          jnp.asarray(tables.entry_pen),
                          jnp.asarray(am_threshold, self.dtype))
        self._exit_pen = (None if tables.exit_pen is None
                          else jnp.asarray(tables.exit_pen))
        self.chunk_latencies_s: List[float] = []
        self.partial_latencies_s: List[float] = []
        self.restart()

    # -- state ---------------------------------------------------------------

    def restart(self) -> None:
        """Reset carried lattice state and buffers (the reference's
        SearchAlgorithm::restart, called at every segment start)."""
        B, W, P = self.num_streams, self._W, self._P
        if self.is_df:
            self._carry = ((jnp.full((B, W, P), BIG, jnp.float32),
                            jnp.zeros((B, W, P), jnp.float32)),
                           jnp.zeros((B, W, P), jnp.int32),
                           (jnp.zeros((B,), jnp.float32),
                            jnp.zeros((B,), jnp.float32)))
        else:
            self._carry = (jnp.full((B, W, P), BIG, self.dtype),
                           jnp.zeros((B, W, P), jnp.int32),
                           jnp.zeros((B,), self.dtype))
        self._buffer: List[np.ndarray] = []     # pending [B, t, dim] pieces
        self._buffered = 0
        self._t_committed = 0
        self._packed: List = []                 # committed [chunk, B] int32

    # -- feeding -------------------------------------------------------------

    def feed(self, frames: np.ndarray) -> None:
        """Append [B, T_any, dim] feature frames; commits full chunks."""
        from ..contracts import require

        frames = np.asarray(frames, np.float32)
        if frames.ndim == 2:
            frames = frames[None]
        require(frames.shape[0] == self.num_streams,
                f"feed expects {self.num_streams} streams, "
                f"got {frames.shape[0]}")
        _check_pack_bounds(self._t_committed + self._buffered
                           + frames.shape[1], self._W)
        self._buffer.append(frames)
        self._buffered += frames.shape[1]
        while self._buffered >= self.chunk:
            self._commit_one_chunk()

    def _take(self, n: int) -> np.ndarray:
        """Pop exactly n buffered frames as one [B, n, dim] array."""
        out = []
        need = n
        while need > 0:
            piece = self._buffer[0]
            if piece.shape[1] <= need:
                out.append(piece)
                need -= piece.shape[1]
                self._buffer.pop(0)
            else:
                out.append(piece[:, :need])
                self._buffer[0] = piece[:, need:]
                need = 0
        self._buffered -= n
        return out[0] if len(out) == 1 else np.concatenate(out, axis=1)

    def _scan_chunk(self, feats: np.ndarray, feat_len: np.ndarray, carry):
        """One chunk through the SAME compiled programs offline uses."""
        B, chunk = self.num_streams, self.chunk
        lens = jnp.asarray(feat_len, jnp.int32)
        t0 = jnp.asarray(self._t_committed, jnp.int32)
        fl = jnp.asarray(feats.reshape(B * chunk, -1))
        if self.is_df:
            am = gmm_mod.am_scores_df(self.pack, fl)
            S = self.pack.num_mixtures
            carry, (_s, w, b) = _decode_scan_df(
                am.hi.reshape(B, chunk, S), am.lo.reshape(B, chunk, S),
                lens, *self._args, prune=self.prune, carry_in=carry, t0=t0)
        else:
            am = gmm_mod.am_scores(self.pack, fl).reshape(
                B, chunk, self.pack.num_mixtures).astype(self.dtype)
            carry, (_s, w, b) = _decode_scan(
                am, lens, *self._args, prune=self.prune, carry_in=carry,
                t0=t0, exit_pen=self._exit_pen)
        return carry, _pack_traceback(w, b)

    def _commit_one_chunk(self) -> None:
        t0 = time.perf_counter()
        feats = self._take(self.chunk)
        # committed frames are all real: mask nothing
        lens = np.full(self.num_streams, self._t_committed + self.chunk,
                       np.int64)
        self._carry, packed = self._scan_chunk(feats, lens, self._carry)
        # store the HOST copy: each committed chunk crosses the
        # device→host boundary exactly once (partial()/finish() would
        # otherwise re-download every chunk per call)
        self._packed.append(np.asarray(packed))
        self._t_committed += self.chunk
        self.chunk_latencies_s.append(time.perf_counter() - t0)

    # -- results -------------------------------------------------------------

    def _traceback(self, feat_len: np.ndarray, extra_packed=()):
        words, bkps = _unpack_traceback(self._packed + list(extra_packed))
        return _traceback_host(words, bkps, feat_len, self.silence_idx)

    def partial(self, feat_len: Optional[Sequence[int]] = None,
                ) -> List[List[int]]:
        """Best transcripts over everything fed so far (the reference's
        getCurrentBestSentence): decodes the uncommitted tail from the
        committed carry WITHOUT committing it."""
        t0 = time.perf_counter()
        total = self._t_committed + self._buffered
        if total == 0:      # callable at any point, incl. before feed()
            self.partial_latencies_s.append(time.perf_counter() - t0)
            return [[] for _ in range(self.num_streams)]
        if feat_len is None:
            feat_len = np.full(self.num_streams, total, np.int64)
        else:
            feat_len = np.minimum(np.asarray(feat_len, np.int64), total)
        extra = ()
        if self._buffered:
            tail = np.concatenate(self._buffer, axis=1) \
                if len(self._buffer) > 1 else self._buffer[0]
            pad = self.chunk - tail.shape[1]
            if pad:
                tail = np.pad(tail, ((0, 0), (0, pad), (0, 0)))
            _carry, packed = self._scan_chunk(tail, feat_len, self._carry)
            extra = (packed,)
        out = self._traceback(feat_len, extra)
        self.partial_latencies_s.append(time.perf_counter() - t0)
        return out

    def finish(self, feat_len: Optional[Sequence[int]] = None,
               ) -> List[List[int]]:
        """Final transcripts; per-stream true lengths may be passed when
        streams were padded to stay lockstep. Identical to the offline
        decode of the same frames (same programs, same chunking)."""
        return self.partial(feat_len)

    @property
    def latency_stats(self) -> dict:
        def stats(xs):
            if not xs:
                return {}
            a = np.asarray(xs)
            return {"mean_s": float(a.mean()), "p50_s": float(np.median(a)),
                    "max_s": float(a.max()), "n": len(xs)}
        return {"chunk_frames": self.chunk,
                "commit": stats(self.chunk_latencies_s),
                "partial": stats(self.partial_latencies_s)}


class OnlineWctsRecognizer:
    """Streaming LVCSR recognition over the word-conditioned tree search
    (the reference's online mode runs exactly this decoder,
    SpeechRecognizer.cc:30-66 + Teaching WCTS): feed feature chunks,
    partial()/finish() transcripts, carried tree-copy lattice state.
    Chunk commits reuse ONE compiled (B, chunk) `_wcts_scan` shape with
    carry_in/t0, so results are bit-identical to the offline
    decode_batch_wcts of the same frames."""

    def __init__(self, pack, tables, tdp_model, lm_matrix, lm_start,
                 am_threshold: float, silence_idx: int,
                 lookahead=None, transparent_silence: bool = False,
                 dtype=jnp.float32, num_streams: int = 1,
                 chunk: int = 64, prune: bool = True):
        from .wcts import LookaheadTables, build_entry_tables, extend_lm

        self.pack = pack
        self.tables = tables
        self.silence_idx = silence_idx
        self.num_streams = num_streams
        self.chunk = chunk
        self.prune = prune
        self.dtype = dtype
        self.transparent = transparent_silence
        self.lm_ext = extend_lm(lm_matrix, lm_start)
        self.C, self.W = self.lm_ext.shape
        self.N = tables.num_nodes
        entry_state, entry_pen = build_entry_tables(tables, tdp_model)
        self._use_la = lookahead is not None
        la = (lookahead.scores(self.lm_ext) if self._use_la
              else np.zeros((self.C, self.N)))
        self._args = (jnp.asarray(tables.state), jnp.asarray(tables.parent),
                      jnp.asarray(tables.grand), jnp.asarray(tables.tdp),
                      jnp.asarray(tables.loop_allowed),
                      jnp.asarray(entry_state), jnp.asarray(entry_pen),
                      jnp.asarray(tables.end_node),
                      jnp.asarray(self.lm_ext), jnp.asarray(la),
                      jnp.asarray(am_threshold, dtype))
        self.chunk_latencies_s: List[float] = []
        self.restart()

    def restart(self) -> None:
        from .decoder import BIG as _BIG

        B, C, N, W = self.num_streams, self.C, self.N, self.W
        big = jnp.asarray(_BIG, self.dtype)
        self._carry = (jnp.full((B, C, N), big, self.dtype),
                       jnp.zeros((B, C, N), jnp.int32),
                       jnp.full((B, W), big, self.dtype),
                       jnp.full((B, C), big, self.dtype),
                       jnp.zeros((B, C), jnp.int32))
        self._buffer: List[np.ndarray] = []
        self._buffered = 0
        self._t_committed = 0
        #: host copies of per-frame outs, appended per committed chunk
        self._outs: List[tuple] = []

    def feed(self, frames: np.ndarray) -> None:
        from ..contracts import require

        frames = np.asarray(frames, np.float32)
        if frames.ndim == 2:
            frames = frames[None]
        require(frames.shape[0] == self.num_streams,
                f"feed expects {self.num_streams} streams, "
                f"got {frames.shape[0]}")
        self._buffer.append(frames)
        self._buffered += frames.shape[1]
        while self._buffered >= self.chunk:
            self._commit()

    def _scan(self, feats: np.ndarray, feat_len: np.ndarray, carry):
        from ..models import gmm as gmm_mod
        from .wcts import _wcts_scan

        B, chunk = self.num_streams, self.chunk
        am = gmm_mod.am_scores(
            self.pack, jnp.asarray(feats.reshape(B * chunk, -1))
        ).reshape(B, chunk, self.pack.num_mixtures).astype(self.dtype)
        return _wcts_scan(
            am, jnp.asarray(feat_len, jnp.int32), *self._args,
            prune=self.prune, use_lookahead=self._use_la,
            transparent_silence=(self.silence_idx if self.transparent
                                 else -1),
            carry_in=carry, t0=jnp.asarray(self._t_committed, jnp.int32))

    def _take(self, n: int) -> np.ndarray:
        out, need = [], n
        while need > 0:
            piece = self._buffer[0]
            if piece.shape[1] <= need:
                out.append(piece)
                need -= piece.shape[1]
                self._buffer.pop(0)
            else:
                out.append(piece[:, :need])
                self._buffer[0] = piece[:, need:]
                need = 0
        self._buffered -= n
        return out[0] if len(out) == 1 else np.concatenate(out, axis=1)

    def _commit(self) -> None:
        t0 = time.perf_counter()
        feats = self._take(self.chunk)
        lens = np.full(self.num_streams, self._t_committed + self.chunk,
                       np.int64)
        self._carry, outs = self._scan(feats, lens, self._carry)
        self._outs.append(tuple(np.asarray(o) for o in outs))
        self._t_committed += self.chunk
        self.chunk_latencies_s.append(time.perf_counter() - t0)

    def _traceback(self, outs_list, feat_len) -> List[List[int]]:
        books = np.concatenate([o[0] for o in outs_list], axis=0)
        bkps = np.concatenate([o[1] for o in outs_list], axis=0)
        preds = np.concatenate([o[2] for o in outs_list], axis=0)
        if self.transparent:
            via = np.concatenate([o[-4] for o in outs_list], axis=0)
            silb = np.concatenate([o[-3] for o in outs_list], axis=0)
            sil_book = np.concatenate([o[-2] for o in outs_list], axis=0)
            sil_bkp = np.concatenate([o[-1] for o in outs_list], axis=0)
        from .decoder import BIG as _BIG

        out: List[List[int]] = []
        for b in range(self.num_streams):
            t = int(feat_len[b])
            if t == 0:
                out.append([])
                continue

            def skip_sil(t: int, c: int) -> int:
                while t > 0 and via[t, b, c]:
                    t = int(silb[t, b, c])
                return t

            seq: List[int] = []
            best_w = float(books[t - 1, b].min())
            if self.transparent:
                best_s = float(sil_book[t - 1, b].min())
                if min(best_w, best_s) >= _BIG * 0.5:
                    out.append([])
                    continue
                if best_s < best_w:
                    c = int(np.argmin(sil_book[t - 1, b]))
                    t = skip_sil(int(sil_bkp[t - 1, b, c]), c)
                    w = c
                else:
                    w = int(np.argmin(books[t - 1, b]))
            else:
                if best_w >= _BIG * 0.5:
                    out.append([])
                    continue
                w = int(np.argmin(books[t - 1, b]))
            while t > 0 and w < self.C - 1:
                if w != self.silence_idx:
                    seq.append(w)
                t, c = int(bkps[t - 1, b, w]), int(preds[t - 1, b, w])
                if self.transparent:
                    t = skip_sil(t, c)
                w = c
            seq.reverse()
            out.append(seq)
        return out

    def partial(self, feat_len=None) -> List[List[int]]:
        total = self._t_committed + self._buffered
        if total == 0:
            return [[] for _ in range(self.num_streams)]
        if feat_len is None:
            feat_len = np.full(self.num_streams, total, np.int64)
        else:
            feat_len = np.minimum(np.asarray(feat_len, np.int64), total)
        outs_list = list(self._outs)
        if self._buffered:
            tail = (self._buffer[0] if len(self._buffer) == 1
                    else np.concatenate(self._buffer, axis=1))
            pad = self.chunk - tail.shape[1]
            if pad:
                tail = np.pad(tail, ((0, 0), (0, pad), (0, 0)))
            _carry, outs = self._scan(tail, feat_len, self._carry)
            outs_list.append(tuple(np.asarray(o) for o in outs))
        return self._traceback(outs_list, feat_len)

    def finish(self, feat_len=None) -> List[List[int]]:
        return self.partial(feat_len)
