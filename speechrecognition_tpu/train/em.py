"""EM training driver: linear segmentation → EM with splitting → realignment.

Orchestration mirrors the reference outer loop (src/sietill/Training.cpp:44-235):

    linear segmentation → accumulate(first_pass) → finalize → write lin.mix
    for i in 0..num_splits:
        if i>0: split(2·min_obs) → acc → finalize → eliminate(min_obs) → acc → finalize
        for j in 0..num_aligns:  realign (pruned Viterbi)
            for k in 0..num_estimates (1 when i==0): acc → finalize
    write <i>.mix each round; AM score after every estimation

The per-frame work (scoring, membership, sufficient statistics) runs on
device in chunks (models/gmm.py); alignment runs as the batched Viterbi
scan (align/viterbi.py); bookkeeping stays on the host in float64.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

import jax.numpy as jnp

from ..config import Configuration, ParameterBool, ParameterFloat, ParameterInt, ParameterString
from ..corpus import Corpus
from ..io import write_alignment, write_mixture_set
from ..lexicon import Lexicon, build_segment_automaton
from ..models.gmm import (MixtureModel, ScorePack, em_accumulate_corpus,
                          em_am_score_corpus)
from ..tdp import TdpModel
from ..align.linear_seg import (linear_alignment_mapping,
                                linear_segmentation_approximation,
                                linear_segmentation_full_dp,
                                linear_segmentation_running_sums)
from ..align.viterbi import AlignerTables, align_batch, align_batch_chunked


@dataclass
class TrainerConfig:
    min_obs: int = 1
    num_splits: int = 1
    num_aligns: int = 1
    num_estimates: int = 1
    pruning_threshold: float = 50.0
    mixture_path: str = ""
    alignment_path: str = ""
    training_stats_path: str = ""
    realign: bool = True
    alignment_pruning: bool = True
    approx_linear_segmentation: bool = True
    #: "" (use the bool above, reference semantics) | "approx" |
    #: "running-sums" | "full-dp" — the reference's three interchangeable
    #: segmentations (Training.cpp:257,350,429); full-dp is its dead-code
    #: exact variant, exposed here for A/B cross-validation
    segmentation_variant: str = ""
    write_linear_segmentation: bool = False
    segmentation_path: str = ""
    batch_size: int = 256
    chunk_frames: int = 1 << 16
    #: resume after an interruption: skip splits < start_split, loading
    #: `<mixture-path><start_split-1>.mix` (the reference restarts the same
    #: way from its per-split checkpoints, Training.cpp:131-136,214-225)
    start_split: int = 0

    @staticmethod
    def from_config(config: Configuration) -> "TrainerConfig":
        return TrainerConfig(
            min_obs=ParameterInt("min-obs", 1)(config),
            num_splits=ParameterInt("num-splits", 1)(config),
            num_aligns=ParameterInt("num-aligns", 1)(config),
            num_estimates=ParameterInt("num-estimates", 1)(config),
            pruning_threshold=ParameterFloat("pruning-threshold", 50.0)(config),
            mixture_path=ParameterString("mixture-path", "")(config),
            alignment_path=ParameterString("alignment-path", "")(config),
            training_stats_path=ParameterString("training-stats-path", "")(config),
            realign=ParameterBool("realign", True)(config),
            alignment_pruning=ParameterBool("alignment-pruning", True)(config),
            approx_linear_segmentation=ParameterBool("approx-linear-segmentation", True)(config),
            write_linear_segmentation=ParameterBool("write-linear-segmentation", False)(config),
            segmentation_path=ParameterString("segmentation-path", "")(config),
            batch_size=ParameterInt("train-batch-size", 256)(config),
            start_split=ParameterInt("start-split", 0)(config),
            segmentation_variant=ParameterString(
                "linear-segmentation-variant", "")(config),
        )


class Trainer:
    def __init__(self, cfg: TrainerConfig, lexicon: Lexicon, model: MixtureModel,
                 tdp: TdpModel, max_approx: bool = True, dtype=jnp.float32,
                 log=print):
        self.cfg = cfg
        self.lexicon = lexicon
        self.model = model
        self.tdp = tdp
        self.max_approx = max_approx
        self.dtype = dtype
        self.log = log
        self.stats_lines: List[str] = []
        #: device-resident corpus (built lazily): [K, C, dim] feature
        #: chunks + [K, C] mask, and the flat [N_pad, dim] feature array
        #: for on-device alignment batch gathers
        self._dev_chunks = None
        self._dev_mask = None
        self._dev_flat = None
        #: state-sorted block cache for the E-step passes: rebuilt when
        #: the alignment changes (one gather per realignment, reused by
        #: every estimate/score pass under that alignment)
        self._align_version = 0
        self._sorted_cache = None
        self.phase_seconds = {"estimate": 0.0, "align": 0.0, "score": 0.0}

    # -- device helpers ------------------------------------------------------

    @property
    def _density_cap(self) -> int:
        """Fixed per-mixture density capacity for the WHOLE training run
        (2^num_splits — splitting at most doubles per split; eliminate only
        shrinks). Padding every device pack to this capacity keeps every
        program shape constant across split rounds, so each EM program
        compiles exactly once."""
        return max(2 ** self.cfg.num_splits,
                   self.model.max_densities_per_mixture)

    def _pack(self):
        """Device scoring pack for the current model: a ScorePackDF on the
        double-float path (dtype="df32" — reference-f64 decisions at f32
        speed), else a plain ScorePack in the requested dtype."""
        if self.dtype == "df32":
            return self.model.pack_df(density_cap=self._density_cap)
        return self.model.pack(dtype=self.dtype,
                               density_cap=self._density_cap)

    def _device_corpus(self, corpus: Corpus):
        """Upload the flat feature store once; every EM pass then runs as a
        single device dispatch."""
        if self._dev_chunks is None:
            C = self.cfg.chunk_frames
            N = corpus.total_frames
            K = -(-N // C)
            fp = np.zeros((K * C, self.model.dim), np.float32)
            fp[:N] = corpus.features
            # one upload; the chunked view is a device-side reshape
            self._dev_flat = jnp.asarray(fp)
            self._dev_chunks = self._dev_flat.reshape(K, C, self.model.dim)
            mask = np.zeros(K * C, np.float32)
            mask[:N] = 1.0
            self._dev_mask = jnp.asarray(mask.reshape(K, C))
        return self._dev_chunks, self._dev_mask

    def _states_chunks(self, alignment: np.ndarray) -> jnp.ndarray:
        K, C, _ = self._dev_chunks.shape
        st = np.zeros(K * C, np.int32)
        st[: alignment.shape[0]] = alignment
        return jnp.asarray(st.reshape(K, C))

    def _sorted_corpus(self, corpus: Corpus, alignment: np.ndarray):
        """State-sorted frame blocks (models/gmm.sorted_blocks) gathered
        on device, cached per alignment version: every E-step/AM-score
        pass under one alignment reuses ONE [NB, BLOCK, dim] gather."""
        from ..models.gmm import sorted_blocks

        if (self._sorted_cache is not None
                and self._sorted_cache[0] == self._align_version):
            return self._sorted_cache[1:]
        self._device_corpus(corpus)
        frame_idx, block_state, _nb = sorted_blocks(
            alignment, self.model.num_mixtures)
        mask = jnp.asarray((frame_idx >= 0).astype(np.float32))
        idx = jnp.asarray(np.maximum(frame_idx, 0))
        frames = self._dev_flat[idx]                    # [NB, BLOCK, dim]
        bs = jnp.asarray(block_state)
        self._sorted_cache = (self._align_version, frames, mask, bs)
        return frames, mask, bs

    def _em_pass(self, corpus: Corpus, alignment: np.ndarray,
                 first_pass: bool = False):
        """One fused AM-score + E-step pass over the sorted blocks;
        returns (per-frame score, stats)."""
        from ..models.gmm import em_pass_sorted

        pack = self._pack()
        if not (first_pass or self.max_approx):
            # Sum-mode EM (CLI max-approx=false): soft logsumexp membership
            # over the aligned mixture's densities (Mixtures.cpp:307-330).
            # The state-sorted pass covers hard membership only, so run the
            # unsorted chunked kernels — still one device dispatch each
            # over the resident corpus.
            if self.dtype == "df32":
                raise NotImplementedError(
                    "sum-mode EM (max-approx=false) needs dtype f32/f64; "
                    "the df32 path covers max-approx only")
            feats, mask = self._device_corpus(corpus)
            st = self._states_chunks(alignment)
            total = em_am_score_corpus(pack, feats, st, mask)
            w, xs, x2s = em_accumulate_corpus(pack, feats, st, mask,
                                              first_pass=False)
            return float(total) / corpus.total_frames, (w, xs, x2s)

        frames, mask, bs = self._sorted_corpus(corpus, alignment)
        total, w, xs, x2s = em_pass_sorted(pack, frames, mask, bs,
                                           first_pass=first_pass)
        return float(total) / corpus.total_frames, (w, xs, x2s)

    def _accumulate(self, corpus: Corpus, alignment: np.ndarray,
                    first_pass: bool) -> None:
        """One E-step over the whole corpus: one fused device pass."""
        t0 = time.perf_counter()
        _score, (w, xs, x2s) = self._em_pass(corpus, alignment, first_pass)
        self.model.apply_statistics(np.asarray(w), np.asarray(xs),
                                    np.asarray(x2s))
        self.phase_seconds["estimate"] += time.perf_counter() - t0

    def _score_and_accumulate(self, corpus: Corpus, alignment: np.ndarray,
                              ) -> float:
        """Fused AM-score + E-step under the CURRENT model: one corpus
        pass and one device round trip where the estimate loop's
        score(M_k)/accumulate(M_k) pair would take two (results are the
        pair's). The statistics are applied to the model in place; the
        returned value is the per-frame AM score."""
        t0 = time.perf_counter()
        score, (w, xs, x2s) = self._em_pass(corpus, alignment)
        self.model.apply_statistics(np.asarray(w), np.asarray(xs),
                                    np.asarray(x2s))
        self.phase_seconds["estimate"] += time.perf_counter() - t0
        return score

    def calc_am_score(self, corpus: Corpus, alignment: np.ndarray) -> float:
        """Average per-frame score under the current alignment
        (reference: Training.cpp:585-612)."""
        t0 = time.perf_counter()
        score, _stats = self._em_pass(corpus, alignment)
        self.phase_seconds["score"] += time.perf_counter() - t0
        return score

    #: alignment padding buckets: a handful of (B, T) shapes ever compile
    #: (arbitrary 32-multiples caused ~40 distinct compiles per corpus)
    ALIGN_BUCKETS = (320, 640, 960, 1280, 1600)

    def _align_bucket(self, length: int) -> int:
        for b in self.ALIGN_BUCKETS:
            if length <= b:
                return b
        return -(-length // self.ALIGN_BUCKETS[-1]) * self.ALIGN_BUCKETS[-1]

    def _realign(self, corpus: Corpus, tables_all: AlignerTables,
                 alignment: np.ndarray) -> None:
        """One whole-corpus realignment. The batch loop only DISPATCHES
        device work (align_batch_chunked return_device=True keeps the
        final-position rule, backtrack, and state gather on device); the
        [B, T] int16 state arrays are fetched together afterwards, so the
        pass pays one synchronization point, not one per batch."""
        t0 = time.perf_counter()
        self._device_corpus(corpus)
        pack = self._pack()
        thr = self.cfg.pruning_threshold if self.cfg.alignment_pruning else None
        order = np.argsort(corpus.lengths, kind="stable")
        Bsz = self.cfg.batch_size
        pending = []
        for i in range(0, corpus.num_segments, Bsz):
            ids = order[i: i + Bsz].tolist()
            n_real = len(ids)
            while len(ids) < Bsz:            # keep shapes static across batches
                ids.append(ids[-1])
            max_len = max(corpus.seq_length(s) for s in ids)
            T = self._align_bucket(max_len)
            # gather the padded batch on device from the resident store
            # (only the [B, T] index array crosses the host boundary)
            offs = corpus.feature_offsets[ids][:, None]
            lens = np.minimum(corpus.lengths[ids], T).astype(np.int32)
            idx = offs + np.arange(T)[None, :]
            idx = np.where(np.arange(T)[None, :] < lens[:, None], idx, 0)
            tables = AlignerTables(states=tables_all.states[ids],
                                   lengths=tables_all.lengths[ids],
                                   tdp=tables_all.tdp[ids])
            if self.dtype == "df32":
                # whole batch as ONE device program (gather + scoring +
                # DP + backtrack + state gather): one dispatch, one
                # deferred fetch
                from ..align.viterbi import _realign_batch_dev
                from ..ops import doublefloat as dfm

                tdp_df = dfm.from_f64(tables.tdp)
                thr_df = dfm.from_f64(np.float64(thr if thr is not None
                                                 else 0.0))
                A = tables.states.shape[1]
                pos_valid = (jnp.arange(A)[None, :]
                             < jnp.asarray(tables.lengths)[:, None])
                states_dev = _realign_batch_dev(
                    pack, self._dev_flat, jnp.asarray(idx),
                    jnp.asarray(lens), jnp.asarray(tables.states),
                    tdp_df.hi, tdp_df.lo, pos_valid,
                    jnp.asarray(tables.lengths, jnp.int32),
                    thr_df.hi, thr_df.lo, T=T,
                    tie_pruned=self.cfg.alignment_pruning,
                    use_pruning=thr is not None)
            else:
                feats = self._dev_flat[jnp.asarray(idx)]
                feats = feats * (jnp.arange(T)[None, :, None]
                                 < jnp.asarray(lens)[:, None, None])
                states_dev, _ = align_batch_chunked(
                    pack, feats, lens, tables, pruning_threshold=thr,
                    tie_pruned=self.cfg.alignment_pruning, dtype=self.dtype,
                    return_device=True)
            pending.append((ids[:n_real], lens, states_dev))
            # bound in-flight batches: enough queue depth to overlap the
            # fetches with compute, not enough to pressure device memory
            # with every batch's scoring intermediates at once
            if len(pending) > 3:
                self._drain_one(corpus, alignment, pending)
        while pending:
            self._drain_one(corpus, alignment, pending)
        self._align_version += 1
        self.phase_seconds["align"] += time.perf_counter() - t0

    @staticmethod
    def _drain_one(corpus: Corpus, alignment: np.ndarray, pending) -> None:
        ids, lens, states_dev = pending.pop(0)
        states = np.asarray(states_dev)
        for b, s in enumerate(ids):
            o = corpus.feature_offsets[s]
            alignment[o: o + lens[b]] = states[b, : lens[b]]

    # -- the outer loop ------------------------------------------------------

    def train(self, corpus: Corpus) -> np.ndarray:
        cfg = self.cfg
        t_start = time.perf_counter()
        automata = [build_segment_automaton(self.lexicon, orth)
                    for orth in corpus.orths]
        tables_all = AlignerTables.build(automata, self.tdp)
        alignment = np.zeros(corpus.total_frames, dtype=np.int32)

        if cfg.start_split > 0:
            self._resume(corpus, tables_all, alignment)
            for i in range(cfg.start_split, cfg.num_splits + 1):
                self._split_round(corpus, tables_all, alignment, i)
            self._finish(t_start)
            return alignment

        # linear segmentation (energy-based initial alignment)
        variant = cfg.segmentation_variant or (
            "approx" if cfg.approx_linear_segmentation else "running-sums")
        for s in range(corpus.num_segments):
            energy = corpus.feature_sequence(s)[:, 0]
            if variant == "approx":
                b1, b2 = linear_segmentation_approximation(energy)
            elif variant == "running-sums":
                b1, b2 = linear_segmentation_running_sums(energy)
            elif variant == "full-dp":
                # bug-compatible one-past-the-end mean: the next segment's
                # first energy in the flat store (Training.cpp:301)
                o_end = corpus.feature_offsets[s] + energy.shape[0]
                nxt = (float(corpus.features[o_end, 0])
                       if o_end < corpus.total_frames else 0.0)
                b1, b2 = linear_segmentation_full_dp(energy, next_energy=nxt)
            else:
                raise ValueError(f"unknown segmentation variant: {variant}")
            o = corpus.feature_offsets[s]
            alignment[o: o + energy.shape[0]] = linear_alignment_mapping(
                automata[s].states, energy.shape[0], b1, b2)
            if cfg.write_linear_segmentation and cfg.segmentation_path:
                self._write_segmentation(
                    f"{cfg.segmentation_path}{corpus.names[s]}.seg",
                    energy, b1, b2)

        self._align_version += 1
        self._accumulate(corpus, alignment, first_pass=True)
        self.model.finalize()
        score = self.calc_am_score(corpus, alignment)
        self.log(f"AM score: {score:.6g}")
        self._stat(f"-1 0 0 {score:g}")
        self.log(f"Num densities: {self.model.num_densities()}")
        if cfg.mixture_path:
            write_mixture_set(cfg.mixture_path + "lin.mix", self.model.to_raw())

        for i in range(cfg.num_splits + 1):
            self._split_round(corpus, tables_all, alignment, i)

        self._finish(t_start)
        return alignment

    def _split_round(self, corpus: Corpus, tables_all: AlignerTables,
                     alignment: np.ndarray, i: int) -> None:
        """One split iteration: split/eliminate, realigns, estimates, and
        the <i>.mix checkpoint (Training.cpp:138-225)."""
        cfg = self.cfg
        if i > 0:
            self.model.split(2 * cfg.min_obs)
            self._accumulate(corpus, alignment, first_pass=False)
            self.model.finalize()
            self.model.eliminate(cfg.min_obs)
            self._accumulate(corpus, alignment, first_pass=False)
            self.model.finalize()
            self.log(f"Num densities: {self.model.num_densities()}")
            score = self.calc_am_score(corpus, alignment)
            self.log(f"AM score (post split): {score:.6g}")
            self._stat(f"{i} -1 0 {score:g}")

        for j in range(cfg.num_aligns):
            if cfg.realign:
                self._realign(corpus, tables_all, alignment)
                if cfg.alignment_path:
                    write_alignment(f"{cfg.alignment_path}{i}-{j}.dump", alignment)
            num_estimates = 1 if i == 0 else cfg.num_estimates
            # estimate loop with fused passes: acc(M_k) → finalize →
            # score(M_{k+1}); score(M_{k+1}) and acc(M_{k+1}) (iteration
            # k+1's E-step) share one corpus pass
            self._accumulate(corpus, alignment, first_pass=False)
            for k in range(num_estimates):
                self.model.finalize()
                if k + 1 < num_estimates:
                    score = self._score_and_accumulate(corpus, alignment)
                else:
                    score = self.calc_am_score(corpus, alignment)
                self.log(f"AM score (accumulate): {score:.6g}")
                self._stat(f"{i} {j} {k} {score:g}")

        if cfg.mixture_path:
            write_mixture_set(f"{cfg.mixture_path}{i}.mix", self.model.to_raw())

    def _resume(self, corpus: Corpus, tables_all: AlignerTables,
                alignment: np.ndarray) -> None:
        """Restart after an interruption: reload the last completed split's
        .mix checkpoint and its alignment dump (or realign from the model
        when no dump was kept) — checkpoint-based recovery, the same
        restartability contract as the reference (SURVEY §5)."""
        import os

        from ..io import read_alignment, read_mixture_set

        cfg = self.cfg
        prev = cfg.start_split - 1
        raw = read_mixture_set(f"{cfg.mixture_path}{prev}.mix", self.model.dim)
        self.model = MixtureModel.from_raw(
            raw, self.model.var_model, max_approx=self.model.max_approx)
        self.log(f"resumed from {cfg.mixture_path}{prev}.mix "
                 f"({self.model.num_densities()} densities)")
        dump = f"{cfg.alignment_path}{prev}-{cfg.num_aligns - 1}.dump"
        if cfg.alignment_path and os.path.exists(dump):
            states, _w, _m = read_alignment(dump)
            if states.shape[0] != corpus.total_frames:
                raise ValueError(
                    f"alignment dump {dump}: {states.shape[0]} frames != "
                    f"corpus {corpus.total_frames}")
            alignment[:] = states
            self._align_version += 1
            self.log(f"resumed alignment from {dump}")
        else:
            self._realign(corpus, tables_all, alignment)

    def _finish(self, t_start: float) -> None:
        if self.cfg.training_stats_path:
            with open(self.cfg.training_stats_path, "w") as f:
                f.write("\n".join(self.stats_lines) + "\n")
        # per-phase timer report (reference: Training.cpp:230-234)
        self.log(f"Estimation  took {self.phase_seconds['estimate']:.1f} seconds")
        self.log(f"Alignment   took {self.phase_seconds['align']:.1f} seconds")
        self.log(f"Score comp. took {self.phase_seconds['score']:.1f} seconds")
        self.log(f"Training took {time.perf_counter() - t_start:.1f} seconds")

    def _stat(self, line: str) -> None:
        self.stats_lines.append(line)

    @staticmethod
    def _write_segmentation(path: str, energy: np.ndarray, b1: int, b2: int,
                            ) -> None:
        """Energy trace + boundary markers for plotting
        (reference: Training.cpp:561-581 .seg format)."""
        import os
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as out:
            for idx, e in enumerate(energy):
                out.write(f"{idx} {e}\n")
            out.write(f"\n{b1} -0.1 \n{b1} .15\n")
            out.write(f"\n{b2 - 1} -0.1 \n{b2 - 1} .15\n")
