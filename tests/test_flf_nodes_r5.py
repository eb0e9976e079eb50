"""Round-5 Flf node families: compose, non-word closures, score
dimensions, CN/fCN IO + combination, oracle alignment, sources
(search/flf_{compose,closure,rescore,cn}.py + the flf_network registry
vs the reference's Flf/NodeRegistration.hh catalog)."""

import io
import math
import re

import numpy as np
import pytest

from speechrecognition_tpu.search.flf import (CnSlot, LatticeArchive,
                                              confusion_network)
from speechrecognition_tpu.search.flf_closure import (
    nonword_closure_filter, nonword_closure_normalization,
    nonword_closure_removal)
from speechrecognition_tpu.search.flf_cn import (
    CnArchive, FcnArchive, align_hypothesis, cn_features, concatenate_fcns,
    fcn_combination, fcn_features, fwer, oracle_align_cn, prune_cn,
    prune_fcn, state_cluster_cn)
from speechrecognition_tpu.search.flf_compose import (
    compose_lattices, compose_with_fsa, compose_with_lm,
    difference_lattices, fit_lattice, intersect_lattices,
    remove_epsilon_arcs)
from speechrecognition_tpu.search.flf_network import (
    NODE_TYPES, FlfNetwork, frame_posterior_cn, fwdbwd_posteriors)
from speechrecognition_tpu.search.flf_rescore import (
    MultiLattice, add_score, append_lattices, change_semiring, exp_score,
    extend_by_penalty, log_score, multiply_score, project_semiring,
    reduce_scores)
from speechrecognition_tpu.search.lattice import Arc, WordLattice
from speechrecognition_tpu.sprint.config import SprintConfig

VOCAB = ["[silence]", "eins", "zwei", "drei", "vier"]

REGISTRATION_HH = ("/root/reference/src/rwth-asr-0.5/src/Flf/"
                   "NodeRegistration.hh")


def _toy():
    """'eins zwei' (best), 'drei zwei', 'drei [sil]', all-silence."""
    arcs = [Arc(0, 3, 1, 1.0), Arc(0, 3, 3, 3.0),
            Arc(3, 6, 2, 1.0), Arc(3, 6, 0, 4.0),
            Arc(0, 6, 0, 9.0)]
    return WordLattice(num_frames=6, arcs=arcs, silence=0)


def _linear(words, n_frames_per=1, score=0.0):
    arcs = [Arc(i, i + 1, w, score) for i, w in enumerate(words)]
    return WordLattice(num_frames=len(words), arcs=arcs, silence=0)


# -- node-name census against the reference registration ----------------------

def test_all_96_reference_node_names_registered():
    with open(REGISTRATION_HH) as f:
        ref = set(re.findall(r'NodeCreator\(\s*"([^"]+)"', f.read()))
    assert len(ref) == 96
    missing = ref - set(NODE_TYPES)
    assert not missing, f"unregistered reference node names: {missing}"


# -- compose family -----------------------------------------------------------

def test_compose_restricts_to_grammar():
    lat = _toy()
    gram = _linear([1, 2])
    c = compose_lattices(lat, gram)
    words, score = c.best_path()
    assert [w for w in words if w > 0] == [1, 2]
    assert score == pytest.approx(2.0)
    # product lattice carries a time map back to real frames
    assert c.times is not None


def test_intersection_equals_compose_for_acceptors():
    lat = _toy()
    gram = _linear([3, 2])
    a = compose_lattices(lat, gram)
    b = intersect_lattices(lat, gram)
    assert a.best_path() == b.best_path()
    assert a.best_path()[1] == pytest.approx(4.0)


def test_difference_removes_accepted_strings():
    lat = _toy()
    # remove the best reading 'eins zwei' → next best is 'drei zwei'
    d = difference_lattices(lat, _linear([1, 2]))
    words, score = d.best_path()
    assert [w for w in words if w > 0] == [3, 2]
    assert score == pytest.approx(4.0)


def test_compose_with_fsa_rescoring():
    from speechrecognition_tpu.fsa.automaton import Automaton

    lat = _toy()
    # acceptor over any words but charging 10 for label 3 (drei)
    arcs = [(0, 0, w, (10.0 if w == 3 else 0.0)) for w in range(5)]
    fsa = Automaton.build(1, arcs, {0: 0.0})
    r = compose_with_fsa(lat, fsa, scale=0.5)
    words, score = r.best_path()
    assert [w for w in words if w > 0] == [1, 2]      # unchanged best
    # the 'drei zwei' path got +0.5·10
    paths = {tuple(w for w in ws if w > 0): sc
             for ws, sc in [r.best_path()]}
    arcs3 = [a for a in r.arcs if a.word == 3]
    assert arcs3 and all(a.score == pytest.approx(3.0 + 5.0)
                         for a in arcs3)


def test_compose_with_lm_matches_manual_scores(tmp_path):
    from speechrecognition_tpu.lm.arpa import ArpaLM

    arpa = tmp_path / "toy.lm"
    arpa.write_text("""
\\data\\
ngram 1=7
ngram 2=2

\\1-grams:
-0.8\t<s>\t-0.3
-0.9\t</s>
-0.7\teins\t-0.2
-0.8\tzwei\t-0.2
-0.9\tdrei\t-0.1
-1.0\tvier\t-0.1
-2.0\t<unk>

\\2-grams:
-0.3\teins zwei\t-0.1
-0.4\t<s> eins\t-0.1

\\end\\
""")
    lm = ArpaLM(str(arpa))
    lat = _toy()
    scale = 2.0
    r = compose_with_lm(lat, lm, VOCAB, scale=scale)
    words, score = r.best_path()
    assert [w for w in words if w > 0] == [1, 2]
    want = (1.0 + 1.0
            + scale * lm.sentence_score(["eins", "zwei"]))
    assert score == pytest.approx(want, rel=1e-9)
    # silence arcs are LM-transparent: the all-silence path costs only
    # its AM score + scaled </s> after <s>
    sil_path_cost = 9.0 + scale * lm.score_str("</s>", ["<s>"])
    sil_arcs = [a for a in r.arcs if a.word == 0 and a.score ==
                pytest.approx(9.0)]
    assert sil_arcs, "silence arc must carry no LM cost"


def test_remove_epsilons_preserves_paths():
    # 1 --eps--> then 2; eps removal folds the eps cost into arcs
    arcs = [Arc(0, 2, 1, 1.0), Arc(2, 3, -1, 0.5), Arc(3, 5, 2, 1.0),
            Arc(2, 5, 2, 2.0)]
    lat = WordLattice(num_frames=5, arcs=arcs, silence=0)
    r = remove_epsilon_arcs(lat)
    assert all(a.word != -1 for a in r.arcs)
    words, score = r.best_path()
    assert [w for w in words if w > 0] == [1, 2]
    assert score == pytest.approx(2.5)


def test_fit_normalizes_boundaries():
    arcs = [Arc(0, 3, 1, 1.0), Arc(3, 4, 2, 1.0)]
    lat = WordLattice(num_frames=6, arcs=arcs, silence=0)
    f = fit_lattice(lat)
    # bridged to the segment end with a free ε arc
    words, score = f.best_path()
    assert score == pytest.approx(2.0)
    assert [w for w in words if w > 0] == [1, 2]
    assert any(a.word == -1 and a.end == 6 for a in f.arcs)


# -- non-word closure family --------------------------------------------------

def _silence_heavy():
    """Parallel silence chains around words to exercise the filters."""
    arcs = [Arc(0, 1, 0, 0.5), Arc(0, 1, 0, 1.5),       # competing sil
            Arc(1, 3, 1, 1.0), Arc(1, 3, 3, 1.2),       # words
            Arc(3, 4, 0, 0.3), Arc(3, 4, 0, 0.1),       # competing sil
            Arc(4, 6, 2, 1.0),
            Arc(3, 6, 2, 2.0)]                          # direct zwei
    return WordLattice(num_frames=6, arcs=arcs, silence=0)


@pytest.mark.parametrize("level", ["arc", "weak", "strong"])
def test_closure_filters_keep_viterbi_and_subgraph(level):
    lat = _silence_heavy()
    ref_words, ref_score = lat.best_path()
    f = nonword_closure_filter(lat, level=level)
    assert set(f.arcs) <= set(lat.arcs)                 # subgraph
    words, score = f.best_path()
    assert score == pytest.approx(ref_score)
    assert words == ref_words


def test_closure_filter_drops_dominated_silence():
    lat = _silence_heavy()
    f = nonword_closure_filter(lat, level="arc")
    # the worse of each competing silence pair disappears
    sil_01 = [a for a in f.arcs if a.word == 0 and a.start == 0]
    assert len(sil_01) == 1 and sil_01[0].score == pytest.approx(0.5)
    sil_34 = [a for a in f.arcs if a.word == 0 and a.start == 3]
    assert len(sil_34) == 1 and sil_34[0].score == pytest.approx(0.1)


def test_strong_det_keeps_one_word_arc_per_group():
    # both 'zwei' routes end at 6 from closure start 3 → strong keeps 1
    lat = _silence_heavy()
    f = nonword_closure_filter(lat, level="strong")
    zwei = [a for a in f.arcs if a.word == 2]
    # best route: sil(0.1) + zwei(1.0) = 1.1 < direct 2.0
    assert len(zwei) == 1 and zwei[0].score == pytest.approx(1.0)


def test_closure_normalization_joins_silence_chains():
    arcs = [Arc(0, 2, 1, 1.0),
            Arc(2, 3, 0, 0.5), Arc(3, 4, 0, 0.25),      # sil chain
            Arc(4, 6, 2, 1.0)]
    lat = WordLattice(num_frames=6, arcs=arcs, silence=0)
    n = nonword_closure_normalization(lat)
    words, score = n.best_path()
    assert score == pytest.approx(2.75)
    joined = [a for a in n.arcs if a.word == 0]
    assert any(a.start == 2 and a.end == 4 and
               a.score == pytest.approx(0.75) for a in joined)
    # the intermediate silence-only state 3 is gone
    assert all(not (a.start == 3 or a.end == 3) or a.word != 0
               for a in n.arcs)


def test_closure_removal_eliminates_nonword_arcs():
    lat = _silence_heavy()
    ref_score = lat.best_path()[1]
    r = nonword_closure_removal(lat)
    assert all(a.word != 0 for a in r.arcs)
    words, score = r.best_path()
    assert score == pytest.approx(ref_score)
    assert [w for w in words if w > 0] == [1, 2]


# -- score dimensions ---------------------------------------------------------

def test_append_and_reduce_roundtrip():
    lat = _toy()
    ml = append_lattices(lat, lat)
    assert ml.keys == ["am", "am-2"]
    v1 = ml.view().best_path()
    red = reduce_scores(ml)
    assert red.view().best_path() == v1            # projection unchanged
    assert np.all(red.dims["am-2"] == 0.0)


def test_append_rejects_topology_mismatch():
    with pytest.raises(ValueError):
        append_lattices(_toy(), _linear([1, 2]))


def test_arithmetic_nodes():
    lat = _toy()
    m = multiply_score(add_score(lat, 1.0), 2.0)
    a0 = m.view().arcs[0]
    assert a0.score == pytest.approx((1.0 + 1.0) * 2.0)
    e = exp_score(lat, scale=-1.0)
    assert e.dims["am"][0] == pytest.approx(math.exp(-1.0))
    l = log_score(e, scale=-1.0)
    assert l.dims["am"][0] == pytest.approx(1.0)


def test_extend_by_penalty_with_classes_and_silence_free():
    lat = _toy()
    ml = extend_by_penalty(lat, 5.0, class_penalties={3: 1.0})
    view = ml.view()
    by_word = {}
    for a in view.arcs:
        by_word.setdefault(a.word, []).append(a.score)
    assert by_word[1][0] == pytest.approx(6.0)     # default penalty
    assert by_word[3][0] == pytest.approx(4.0)     # class override
    assert by_word[0] == [4.0, 9.0]                # silence free


def test_change_semiring_and_project():
    ml = append_lattices(_toy(), _toy())
    cs = change_semiring(ml, {"am": 0.5, "am-2": 0.0})
    best = cs.view().best_path()[1]
    assert best == pytest.approx(0.5 * 2.0)
    pr = project_semiring(cs, ["am"])
    assert pr.keys == ["am"]


# -- CN / fCN -----------------------------------------------------------------

def test_cn_archive_roundtrip(tmp_path):
    slots = confusion_network(_toy())
    arch = CnArchive(str(tmp_path / "cns"))
    arch.write("s1", slots)
    back = arch.read("s1")
    assert arch.list() == ["s1"]
    assert len(back) == len(slots)
    for a, b in zip(slots, back):
        assert a.start == b.start and a.end == b.end
        for w, p in a.probs.items():
            assert b.probs[w] == pytest.approx(p, rel=1e-9)


def test_fcn_archive_roundtrip(tmp_path):
    pcn = frame_posterior_cn(_toy())
    arch = FcnArchive(str(tmp_path / "fcns"))
    arch.write("s1", pcn)
    back = arch.read("s1")
    assert len(back) == len(pcn)
    for a, b in zip(pcn, back):
        for w, p in a.items():
            assert b[w] == pytest.approx(p, rel=1e-9)


def test_prune_cn_mass_and_size():
    slots = [CnSlot(0, 2, {1: 0.6, 2: 0.25, 3: 0.1})]
    m = prune_cn(slots, threshold=0.8)
    assert set(m[0].probs) == {1, 2}
    s = prune_cn(slots, max_slot_size=1, normalize=True)
    assert set(s[0].probs) == {1}
    # ε (0.05) participates in the renormalization
    assert s[0].probs[1] == pytest.approx(0.6 / (0.6 + 0.05))
    e = prune_cn([CnSlot(0, 2, {1: 0.1})], remove_eps_slots=0.8)
    assert e == []


def test_prune_fcn():
    pcn = [{1: 0.5, 2: 0.3, 3: 0.1}]
    out = prune_fcn(pcn, max_slot_size=2)
    assert set(out[0]) == {1, 2}


def test_fcn_combination_mixture_and_max():
    f1 = [{1: 0.8, 2: 0.2}]
    f2 = [{1: 0.2, 2: 0.6}]
    mix = fcn_combination([f1, f2])
    assert mix[0][1] == pytest.approx(0.5)
    assert mix[0][2] == pytest.approx(0.4)
    mx = fcn_combination([f1, f2], max_approx=True)
    assert mx[0][1] == pytest.approx(0.8)
    w = fcn_combination([f1, f2], weights=[3, 1])
    assert w[0][1] == pytest.approx(0.75 * 0.8 + 0.25 * 0.2)


def test_concatenate_fcns():
    out = concatenate_fcns([[{1: 1.0}], [{2: 1.0}, {3: 0.5}]])
    assert len(out) == 3 and out[2] == {3: 0.5}


def test_oracle_alignment_costs():
    slots = [CnSlot(0, 2, {1: 0.7, 3: 0.3}),
             CnSlot(2, 4, {2: 0.9})]
    rows, cost = oracle_align_cn(slots, [1, 2])
    assert rows == [(0, 1), (1, 2)] and cost == 0.0
    rows, cost = oracle_align_cn(slots, [4, 2])
    assert cost == pytest.approx(1.0)              # 4 not in slot 0
    _rows, closs = oracle_align_cn(slots, [1, 2], cost="oracle-loss")
    assert closs == pytest.approx((1 - 0.7) + (1 - 0.9))
    _rows, wcost = oracle_align_cn(slots, [3, 2],
                                   cost="weighted-oracle-error", alpha=2.0)
    assert wcost == pytest.approx(1.0)             # rank 1 ** 2


def test_cn_features():
    lat = _toy()
    slots = confusion_network(lat)
    conf = cn_features(lat, slots, feature="confidence")
    a_eins = lat.arcs[0]
    assert 0.0 < conf[a_eins] <= 1.0
    ent = cn_features(lat, slots, feature="entropy")
    assert all(v >= 0 for v in ent.values())
    slot_of = cn_features(lat, slots, feature="slot")
    assert set(slot_of.values()) <= set(float(i) for i in range(len(slots)))
    cost = cn_features(lat, slots, feature="cost", oracle=[1, 2])
    assert cost[a_eins] == 0.0


def test_fcn_features_error_and_confidence():
    lat = _toy()
    pcn = frame_posterior_cn(lat)
    conf = fcn_features(lat, pcn, feature="confidence")
    err0 = fcn_features(lat, pcn, feature="error", alpha=0.0)
    a = lat.arcs[0]
    # unsmoothed expected error = Σ (1 − p_t)
    want = sum(1.0 - pcn[t].get(1, 0.0) for t in range(0, 3))
    assert err0[a] == pytest.approx(want)
    assert conf[a] == pytest.approx(1.0 - want / 3)


def test_fwer_linear_and_fcn():
    hyp = WordLattice(num_frames=6, arcs=[Arc(0, 3, 1, 0), Arc(3, 6, 2, 0)],
                      silence=0)
    ref = WordLattice(num_frames=6, arcs=[Arc(0, 3, 1, 0), Arc(3, 6, 0, 0)],
                      silence=0)
    err, T = fwer(hyp, ref=ref)
    assert (err, T) == (3.0, 6)
    pcn = frame_posterior_cn(_toy())
    exp_err, _ = fwer(hyp, ref_fcn=pcn)
    want = sum(1.0 - pcn[t].get(1, 0.0) for t in range(3)) + \
        sum(1.0 - pcn[t].get(2, 0.0) for t in range(3, 6))
    assert exp_err == pytest.approx(want)


def test_aligner_intersection_then_fcn():
    lat = _toy()
    rows = align_hypothesis([1, 2], lat)
    assert [(w, s, e) for w, s, e in rows if w > 0] == [(1, 0, 3),
                                                       (2, 3, 6)]
    # word sequence NOT in the lattice → falls back to fCN alignment
    rows2 = align_hypothesis([1, 4], lat)
    assert [w for w, _s, _e in rows2] == [1, 4]
    assert rows2[0][1] == 0 and rows2[-1][2] == 6


def test_state_cluster_cn_decodes_best():
    lat = _toy()
    slots = state_cluster_cn(lat)
    from speechrecognition_tpu.search.flf import cn_decode
    assert cn_decode(slots) == [1, 2]
    # posteriors in each slot are ≤ 1 and sum with ε to ≈ 1
    for s in slots:
        assert sum(s.probs.values()) <= 1.0 + 1e-9


# -- network-level: sources, Ports plumbing, end-to-end -----------------------

def test_network_with_new_node_families(tmp_path):
    """End-to-end network using ≥3 new families: compose (grammar
    restriction), non-word closure filter, score arithmetic, CN archive
    writer + oracle alignment."""
    arch_dir = tmp_path / "lats"
    arch = LatticeArchive(str(arch_dir), VOCAB)
    arch.write("seg-1", _toy())
    trans = tmp_path / "refs.txt"
    trans.write_text("seg-1\teins zwei\n")
    cfg = tmp_path / "net.config"
    cfg.write_text(f"""
[network.reader]
type = archive-reader
path = {arch_dir}
links = grammar:0 closure
[network.str]
type = string-to-lattice
string = eins zwei
links = grammar:1
[network.grammar]
type = compose
links = best
[network.best]
type = best
[network.closure]
type = non-word-closure-filter
links = pen
[network.pen]
type = extend-by-penalty
penalty = 2.5
links = cn
[network.cn]
type = center-frame-CN-builder
links = cnwriter oracle
[network.cnwriter]
type = CN-archive-writer
path = {tmp_path / 'cns'}
[network.oracle]
type = oracle-alignment
transcripts = {trans}
""")
    out = io.StringIO()
    net = FlfNetwork.parse(SprintConfig.read(str(cfg)), VOCAB, silence=0)
    r = net.run(["seg-1"], out=out)["seg-1"]
    assert r["best"] == [1, 2]
    assert r["oracle"] == [(0, 1), (1, 2)]
    assert CnArchive(str(tmp_path / "cns")).list() == ["seg-1"]
    assert "oracle-cost=0.0000" in out.getvalue()


def test_ports_multi_output_nodes(tmp_path):
    """dump-CN exposes 3 ports; select-n-best exposes per-rank ports;
    buffer manifolds to all ports."""
    arch_dir = tmp_path / "lats"
    arch = LatticeArchive(str(arch_dir), VOCAB)
    arch.write("seg-1", _toy())
    cfg = tmp_path / "net.config"
    cfg.write_text(f"""
[network.reader]
type = archive-reader
path = {arch_dir}
links = buffer
[network.buffer]
type = buffer
links = 0->nbest:0 1->cnb:0
[network.nbest]
type = n-best
n = 3
links = select
[network.select]
type = select-n-best
links = 1->secondsink:0
[network.secondsink]
type = sink
[network.cnb]
type = CN-builder
links = dump
[network.dump]
type = dump-CN
links = 1->cnsink:0 0->latsink:0
[network.cnsink]
type = sink
[network.latsink]
type = sink
""")
    out = io.StringIO()
    net = FlfNetwork.parse(SprintConfig.read(str(cfg)), VOCAB, silence=0)
    r = net.run(["seg-1"], out=out)["seg-1"]
    # select-n-best port 1 → the 2nd-best hypothesis as a linear lattice
    second = r["secondsink"]
    assert isinstance(second, WordLattice)
    assert [a.word for a in second.arcs if a.word > 0] != []
    # dump-CN port 1 is the CN, port 0 a sausage lattice
    assert isinstance(r["cnsink"], list)
    assert isinstance(r["latsink"], WordLattice)
    assert "seg-1" in out.getvalue()


def test_batch_and_segment_builder_sources(tmp_path):
    batch_file = tmp_path / "batch.txt"
    batch_file.write_text("seg-1 file-a.wav\nseg-2 file-b.wav\n")
    cfg = tmp_path / "net.config"
    cfg.write_text("""
[network.batch]
type = batch
links = 0->builder:9 1->builder:1
[network.builder]
type = segment-builder
links = sink
[network.sink]
type = sink
""")
    out = io.StringIO()
    net = FlfNetwork.parse(SprintConfig.read(str(cfg)), VOCAB, silence=0)
    res = net.run_batch_file(str(batch_file), out=out)
    assert set(res) == {"seg-1", "seg-2"}
    seg = res["seg-1"]["builder"]
    assert seg["id"] == "seg-1"
    assert seg["audio-filename"] == "file-a.wav"


def test_drawer_and_dump_vocab_and_ctm_reader(tmp_path):
    lat = _toy()
    arch_dir = tmp_path / "lats"
    LatticeArchive(str(arch_dir), VOCAB).write("seg-1", lat)
    ctm = tmp_path / "hyp.ctm"
    ctm.write_text("seg-1 1 0.00 0.03 eins 0.9\n"
                   "seg-1 1 0.03 0.03 zwei 0.8\n")
    cfg = tmp_path / "net.config"
    cfg.write_text(f"""
[network.reader]
type = archive-reader
path = {arch_dir}
links = drawer vocab
[network.drawer]
type = drawer
path = {tmp_path / 'dots'}
[network.vocab]
type = dump-vocab
[network.ctm]
type = ctm-reader
file = {ctm}
links = ctmbest
[network.ctmbest]
type = best
""")
    out = io.StringIO()
    net = FlfNetwork.parse(SprintConfig.read(str(cfg)), VOCAB, silence=0)
    r = net.run(["seg-1"], out=out)["seg-1"]
    dot = (tmp_path / "dots" / "seg-1.dot").read_text()
    assert "digraph" in dot and "eins" in dot
    assert r["vocab"] == ["[silence]", "eins", "zwei", "drei"]
    assert r["ctmbest"] == [1, 2]


def test_recognizer_node_produces_lattice(tmp_path, fixtures_dir):
    """In-network recognizer: sietill demo system → lattice whose best
    path matches the standalone decoder's golden transcript."""
    import json

    with open(fixtures_dir / "demo_recognition.json") as f:
        golden = json.load(f)
    cfg = tmp_path / "net.config"
    cfg.write_text(f"""
[network.rec]
type = recognizer
mixture-file = {fixtures_dir / 'iter-2.mix'}
corpus = {fixtures_dir / 'demo_corpus.json'}
feature-path = {fixtures_dir / 'demo_features'}/
normalization = {fixtures_dir / 'normalization-demo.bin'}
word-penalty = {golden['config']['word_penalty']}
tdp = {golden['config']['tdp'][0]} {golden['config']['tdp'][1]} {golden['config']['tdp'][2]}
am-threshold = 200
links = best
[network.best]
type = best
""")
    from speechrecognition_tpu.lexicon import build_sietill_lexicon
    lexicon = build_sietill_lexicon()
    vocab = list(lexicon.orth)
    out = io.StringIO()
    net = FlfNetwork.parse(SprintConfig.read(str(cfg)), vocab,
                           silence=lexicon.silence_idx)
    seg0 = golden["utts"][0]
    from speechrecognition_tpu.corpus import CorpusDescription
    desc = CorpusDescription.read(str(fixtures_dir / "demo_corpus.json"),
                                  lexicon)
    name = desc.segments[seg0["idx"]].name
    r = net.run([name], out=out)[name]
    hyp = [w for w in r["best"] if w != lexicon.silence_idx]
    assert hyp == seg0["hyp"]
