"""The port's corpus pipeline, front half (ANALYZE -> COMPOSE -> STATS ->
HALGN -> MKDAT), and its host modules, against the JAX package on the CPU.

Host modules (labels, LOWESS, vibrato, HTK files, corpus lists, labelgen,
the stage manifest) are copies and are held bit for bit or byte for byte
on the same seeded inputs; the native loader against scipy / numpy reads.
The pipeline runs end to end on a 3-utterance 16 kHz corpus with note
names and one vibrato note, the port with device="cpu": ANALYZE within
tests/test_torch_features.py's `bucketed_extract` tolerances; then, from
the JAX run's stream files, COMPOSE, STATS, HALGN and MKDAT byte for byte.
"""
import filecmp
import json
import os
import shutil

import numpy as np
import pytest
from scipy.io import wavfile

import chip_smoke
from hts_train_world_tpu.features import corpus as jcorpus
from hts_train_world_tpu.features import htk as jhtk
from hts_train_world_tpu.features import labelgen as jlabelgen
from hts_train_world_tpu.features import labels as jlabels
from hts_train_world_tpu.features import lowess as jlowess
from hts_train_world_tpu.features import vibrato as jvibrato
from hts_train_world_tpu.models import clustering as jclustering
from hts_train_world_tpu.models import hsmm as jhsmm
from hts_train_world_tpu.models import recipe as jrecipe
from hts_train_world_tpu.runtime import checkpoint as jcheckpoint
from hts_train_world_tpu.runtime import pipeline as jpl
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.features import corpus, htk, labelgen
from hts_train_world_tpu_torch.features import labels, lowess, vibrato
from hts_train_world_tpu_torch.io import loader, rawio, wavio
from hts_train_world_tpu_torch.features import qconf
from hts_train_world_tpu_torch.models import clustering, hsmm, recipe
from hts_train_world_tpu_torch.runtime import checkpoint
from hts_train_world_tpu_torch.runtime import pipeline as pl

FS = 16000
NOTES = ["G3", "A3", "Bb3"]
QCONF = """
C-Phone_a  {*-a+*}
C-Phone_i  {*-i+*}
C-Phone_sil {*-sil+*}
C-Note_G3 {*/E:G3]*}
C-Note_A3 {*/E:A3]*}
C-Note_Bb3 {*/E:Bb3]*}
Pos_C-Frame_in_Phone(Fw)  MIN=1 MAX=200
Pos_C-Frame_in_Phone(Bw)  MIN=1 MAX=200
"""
# HALGN's recipe: the pipeline's default (JAX pipeline.py:254-256) with
# segmental (hard) counts.  With soft counts a note state of this corpus
# holds an occupancy of 1.0 frame within rounding, min_occupancy's
# threshold, and the two packages' last bits take the split either way
# (a tie in both, ROADMAP Queue C); hard counts are whole frames.
HALGN = dict(n_states=5, n_iters=2, tied_iters=1, recluster=False,
             use_gv=False, use_mspf=False, soft_counts=False)


def make_corpus(wd, fs=FS, n_utt=3):
    """tests/test_pipeline.py's corpus with note names (G3, A3, Bb3) and
    a 5.5 Hz vibrato of 3 % on the first utterance's note."""
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(wd, "raw"), exist_ok=True)
    os.makedirs(os.path.join(wd, "labels", "full"), exist_ok=True)
    os.makedirs(os.path.join(wd, "labels", "mono"), exist_ok=True)
    for u in range(n_utt):
        dur = 0.6
        n = int(fs * dur)
        t = np.arange(n) / fs
        f0 = np.full(n, 200.0 + 20 * u)
        if u == 0:
            f0 *= 1.0 + 0.03 * np.sin(2 * np.pi * 5.5 * t)
        ph = np.cumsum(2 * np.pi * f0 / fs)
        x = (0.5 * np.sin(ph) + 0.25 * np.sin(2 * ph)
             + 0.01 * rng.standard_normal(n))
        edge = n // 8
        x[:edge] *= 0
        x[-edge:] *= 0
        x += 0.003 * rng.standard_normal(n)
        wavio.wavwrite(0.8 * x / np.abs(x).max(), fs,
                       os.path.join(wd, "raw", f"utt{u}.wav"))
        d = int(dur * 1e7)
        e1, e2 = d // 8, d - d // 8
        lines = [f"0 {e1} x^x-sil+a=x/E:xx]",
                 f"{e1} {e2} x^sil-a+sil=x/E:{NOTES[u]}]",
                 f"{e2} {d} x^a-sil+x=x/E:xx]"]
        with open(os.path.join(wd, "labels", "full", f"utt{u}.lab"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(wd, "qconf.conf"), "w") as f:
        f.write(QCONF)


# ---------------------------------------------------------------------------
# host modules
# ---------------------------------------------------------------------------


def _label_files(d):
    full = os.path.join(d, "full.lab")
    lines = ["0 1250000 x^x-sil+a=x/E:xx]",
             "1250000 4000000 x^sil-a+i=x/E:A3]",
             "4000000 5500000 x^a-i+sil=x/E:Db5]",
             "5500000 6000000 x^i-sil+x=x/E:H4]",
             "6000000 7250000 x^sil-a+x=x/E:xx]"]
    with open(full, "w") as f:
        f.write("\n".join(lines) + "\n")
    return full


def test_labels_match_jax(tmp_path):
    full = _label_files(tmp_path)
    mono_j, mono_t = str(tmp_path / "mj.lab"), str(tmp_path / "mt.lab")
    jlabels.make_mono_from_full(full, mono_j)
    labels.make_mono_from_full(full, mono_t)
    assert filecmp.cmp(mono_j, mono_t, shallow=False)
    segs, jsegs = (m.load_labels(mono_j, full) for m in (labels, jlabels))
    assert len(segs) == 5
    for s, j in zip(segs, jsegs):
        assert (s.start_ms, s.end_ms, s.phone, s.context, s.note) == \
            (j.start_ms, j.end_ms, j.phone, j.context, j.note)
        assert s.note_hz() == j.note_hz()
        assert labels.segment_frames(s, 5.0, 120) == \
            jlabels.segment_frames(j, 5.0, 120)
    assert segs[1].note_hz() == 220.0 and segs[3].note_hz() == 0.0
    ctx = [s.context for s in segs]
    ends = np.cumsum(np.random.default_rng(1).integers(1, 9, 5 * 3))
    for fn in ("state_alignment_lines", "phone_alignment_lines"):
        assert getattr(labels, fn)(ctx, ends, 3, 50000) == \
            getattr(jlabels, fn)(ctx, ends, 3, 50000)
    durs = np.diff(np.concatenate([[0], ends]))
    assert labels.durations_to_state_lines(ctx, durs, 3, 50000) == \
        jlabels.durations_to_state_lines(ctx, durs, 3, 50000)


@pytest.mark.parametrize("n,it", [(1, 20), (7, 3), (60, 20), (211, 20)])
def test_lowess_bit_equal_to_jax(n, it):
    rng = np.random.default_rng(n)
    x = np.arange(n, dtype=float)
    y = 6.0 * np.sin(2 * np.pi * x / 36.0) + 0.3 * x \
        + rng.standard_normal(n)
    y[n // 3] += 40.0 if n > 3 else 0.0       # an outlier the robust pass
    got = lowess.lowess(y, x, it=it)          # weights down
    np.testing.assert_array_equal(got, jlowess.lowess(y, x, it=it))


def _vibrato_case(seed=3, T=400):
    """lf0 over five labelled segments: a vibrato note (6 Hz depth, 5.5 Hz
    rate), a flat note, an unvoiced gap, a note below the voicing floor,
    and a tail outside every label."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) * 0.005
    f0 = np.full(T, 220.0) * (1 + 0.03 * np.sin(2 * np.pi * 5.5 * t))
    f0[100:180] = 261.6 + rng.standard_normal(80)
    f0[180:200] = 0.0
    f0[200:260] = 50.0
    f0[340:] = 0.0
    lf0 = np.where(f0 > 0, np.log(np.maximum(f0, 1e-300)), 0.0)
    segs_t = [labels.LabelSegment(0.0, 500.0, "a", "x/E:A3]"),
              labels.LabelSegment(500.0, 1000.0, "i", "x/E:C4]"),
              labels.LabelSegment(1000.0, 1300.0, "a", "x/E:G2]"),
              labels.LabelSegment(1300.0, 1700.0, "sil", "x/E:xx]")]
    segs_j = [jlabels.LabelSegment(s.start_ms, s.end_ms, s.phone, s.context)
              for s in segs_t]
    return lf0.astype(np.float32), segs_t, segs_j


@pytest.mark.parametrize("with_labels", [True, False])
def test_vibrato_extract_bit_equal_to_jax(with_labels):
    lf0, segs_t, segs_j = _vibrato_case()
    got = vibrato.extract(lf0, segs_t if with_labels else [], 5.0)
    want = jvibrato.extract(lf0, segs_j if with_labels else [], 5.0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    if with_labels:                    # the vibrato note was found
        depth = np.exp(got[1][:100, 0].astype(np.float64))
        assert 5.0 <= np.median(depth) <= 8.0
    np.testing.assert_array_equal(vibrato.lf0_to_f0(lf0),
                                  jvibrato.lf0_to_f0(lf0))
    df0 = np.sin(np.arange(90) / 3.0) * 9.0
    for g, w in zip(vibrato.extract_vibrato_segment(df0),
                    jvibrato.extract_vibrato_segment(df0)):
        np.testing.assert_array_equal(g, w)


def test_htk_and_corpus_files_byte_equal(tmp_path):
    data = np.random.default_rng(2).standard_normal((37, 237))
    for m, name in ((htk, "t"), (jhtk, "j")):
        m.write_htk(str(tmp_path / f"{name}.cmp"), data, 48000, 240)
    assert filecmp.cmp(tmp_path / "t.cmp", tmp_path / "j.cmp", shallow=False)
    got, period, kind = htk.read_htk(str(tmp_path / "j.cmp"))
    np.testing.assert_array_equal(got, data.astype(np.float32))
    assert (period, kind) == (50000, 9)
    with open(tmp_path / "t.cmp", "rb") as f:
        head = f.read(12)
    assert np.frombuffer(head[:8], "=i4").tolist() == [37, 50000]
    assert np.frombuffer(head[8:], "=i2").tolist() == [4 * 237, 9]

    lab = tmp_path / "labs"
    lab.mkdir()
    for i, full in enumerate(("a b x^sil-a+i\nc d x^a-i+x\n",
                              "a b x^sil-a+i\nc d x^i-sil+x\n")):
        (lab / f"u{i}.lab").write_text(full)
    (tmp_path / "cmp").mkdir()
    for i in range(2):
        shutil.copy(tmp_path / "t.cmp", tmp_path / "cmp" / f"u{i}.cmp")
    for m, name in ((corpus, "t"), (jcorpus, "j")):
        assert m.write_scp(str(tmp_path / "cmp"),
                           str(tmp_path / f"{name}.scp"))
        m.write_mlf(str(lab), str(tmp_path / f"{name}.mlf"))
        m.model_list(str(lab), str(tmp_path / f"{name}.list"))
        m.mono_list(str(lab), str(tmp_path / f"{name}.mono"))
    for ext in ("scp", "mlf", "list", "mono"):
        assert filecmp.cmp(tmp_path / f"t.{ext}", tmp_path / f"j.{ext}",
                           shallow=False)


def _feats_rows(rng, n=8):
    """tests/test_labelgen.py's synthetic dumpfeats rows."""
    phones = ["a", "i", "u", "pau", "k", "s"]
    rows = []
    t = 0.0
    for i in range(n):
        f = []
        for j in range(1, 67):
            if j in (1, 2, 3, 63, 64):
                v = phones[int(rng.integers(0, len(phones)))]
                if j != 2 and rng.random() < 0.3:
                    v = "0"
            elif j in (65, 66):
                v = f"{t:.4f}" if j == 65 else f"{t + 0.08:.4f}"
            else:
                v = str(int(rng.integers(0, 9)))
            f.append(v)
        if i == 2:
            f[1] = "pau"
        t += 0.08
        rows.append(" ".join(f))
    return "\n".join(rows) + "\n"


@pytest.mark.parametrize("seed", [0, 3])
def test_labelgen_matches_jax(seed):
    feats = _feats_rows(np.random.default_rng(seed))
    assert labelgen.full_labels(feats) == jlabelgen.full_labels(feats)
    assert labelgen.mono_labels(feats) == jlabelgen.mono_labels(feats)
    for text in ("Hello world.",
                 "this is a test, with 3 numbers 4.5 and hy-phen",
                 "Is this a question?", "version 2.1 release"):
        assert labelgen.normalize_text(text) == \
            jlabelgen.normalize_text(text)


def test_stage_manifest_json_equal(tmp_path):
    for m, d in ((checkpoint, "t"), (jcheckpoint, "j")):
        man = m.StageManifest(str(tmp_path / d))
        man.mark("ANALYZE", n=3)
        man.mark("COMPOSE")
        man.mark("HALGN", skipped=True)
        man.reset_from("HALGN", pl.STAGES)
        assert man.done("COMPOSE") and not man.done("HALGN")
        assert m.StageManifest(str(tmp_path / d)).done("ANALYZE")
    with open(tmp_path / "t" / "stages.json") as a, \
            open(tmp_path / "j" / "stages.json") as b:
        ta, tb = a.read(), b.read()
    assert ta == tb and json.loads(ta)["ANALYZE"] == {"done": True, "n": 3}


# ---------------------------------------------------------------------------
# the native loader (tests/test_loader.py's checks)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("load")
    rng = np.random.default_rng(0)
    raws, wavs, f32s = [], [], []
    for i, n in enumerate([1000, 4321, 12345]):
        x = (rng.standard_normal(n) * 8000).astype(np.int16)
        raws.append(str(d / f"u{i}.raw"))
        x.astype("<i2").tofile(raws[-1])
        wavs.append(str(d / f"u{i}.wav"))
        wavfile.write(wavs[-1], 16000 + i, x)
        f32s.append(str(d / f"u{i}.lf0"))
        rawio.write_f32(f32s[-1], rng.standard_normal(n).astype(np.float32))
    return d, raws, wavs, f32s


def test_loader_bit_equal_to_reads(files):
    d, raws, wavs, f32s = files
    for p, g in zip(raws, loader.load_corpus(raws, loader.RAW_INT16,
                                             n_threads=3)):
        np.testing.assert_array_equal(
            g, np.fromfile(p, "<i2").astype(np.float64) / 32768.0)
    with loader.CorpusLoader(wavs, loader.WAV, n_threads=2) as dl:
        seen = {i: (x, sr) for i, x, sr in dl}
    assert sorted(seen) == [0, 1, 2]
    for i, p in enumerate(wavs):
        sr, ref = wavfile.read(p)
        assert seen[i][1] == sr == 16000 + i
        np.testing.assert_array_equal(seen[i][0], ref / 32768.0)
    for p, g in zip(f32s, loader.load_corpus(f32s, loader.F32)):
        np.testing.assert_array_equal(g, np.fromfile(p, "<f4"))
    bad = str(d / "missing.raw")
    assert loader.load_corpus([raws[0], bad], loader.RAW_INT16)[1] is None
    assert loader.load_corpus([], loader.WAV) == []


def test_native_build_lands_outside_the_sources():
    from hts_train_world_tpu_torch.runtime import native
    lib = native.load("dataloader", ["dataloader.cpp"])
    assert os.path.dirname(lib._name).startswith(native.BUILD_ROOT)
    assert not [n for n in os.listdir(native.NATIVE_DIR)
                if n.endswith(".so")]


# ---------------------------------------------------------------------------
# the pipeline, end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX pipeline up to MKDAT; the port's ANALYZE (its own files
    kept aside), then COMPOSE..MKDAT from the JAX run's stream files."""
    wj = str(tmp_path_factory.mktemp("jax"))
    wt = str(tmp_path_factory.mktemp("port"))
    for wd in (wj, wt):
        make_corpus(wd)
    jpl.SingingPipeline(jpl.PipelineConfig(
        wj, fs=FS, use_hmm_align=True,
        hmm=jrecipe.RecipeConfig(**HALGN))).run(upto="MKDAT")
    kernels.reset_counts()
    p = pl.SingingPipeline(pl.PipelineConfig(
        wt, fs=FS, use_hmm_align=True, hmm=recipe.RecipeConfig(**HALGN),
        device="cpu"))
    p.run(upto="ANALYZE")
    own = {s: [rawio.read_f32(p._p(s, f"utt{u}", s)) for u in range(3)]
           for s in ("lf0", "mgc", "bap", "vib")}
    for s in own:
        for u in range(3):
            shutil.copy(os.path.join(wj, s, f"utt{u}.{s}"),
                        p._p(s, f"utt{u}", s))
    p.run(upto="MKDAT")
    return wj, wt, own, p


def test_analyze_matches_jax(runs):
    """tests/test_torch_features.py's bucketed_extract gates on the files:
    lf0 (both dims) V/UV agreement > 0.9 and median |d| < 1e-3 where both
    are voiced; mgc and bap median |d| (their decoded spectra are held
    there; here the coefficients, < 0.01); vib from the same lf0 within
    1e-12 (below)."""
    wj, _, own, _ = runs
    lay = pl.compose.StreamLayout()
    for u in range(3):
        lf0 = own["lf0"][u].reshape(-1, 2)
        jlf0 = rawio.read_f32(os.path.join(wj, "lf0", f"utt{u}.lf0"), 2)
        assert lf0.shape == jlf0.shape == (121, 2)
        for k in range(2):
            assert ((lf0[:, k] != 0) == (jlf0[:, k] != 0)).mean() > 0.9
            both = (lf0[:, k] != 0) & (jlf0[:, k] != 0)
            assert both.mean() > 0.5
            assert np.median(np.abs(lf0[both, k] - jlf0[both, k])) < 1e-3
        for s, dim in (("mgc", lay.mgc_dim), ("bap", lay.bap_dim)):
            got = own[s][u].reshape(-1, dim)
            want = rawio.read_f32(os.path.join(wj, s, f"utt{u}.{s}"), dim)
            assert got.shape == want.shape and np.isfinite(got).all()
            assert np.median(np.abs(got - want)) < 0.01
    # the vibrato note: depth found on the first utterance, none elsewhere
    vib0 = np.exp(own["vib"][0].reshape(-1, 2)[:, 0].astype(np.float64))
    assert vib0.max() >= 5.0
    assert (own["vib"][1] == np.float32(1e-8)).all()


def test_vib_from_identical_lf0_matches_jax(runs):
    """vibrato.extract of the JAX run's lf0 (dim 0, back to ln f0) and
    labels: the port's and the JAX module's within 1e-12."""
    wj, wt, _, _ = runs
    full = os.path.join(wt, "labels", "full", "utt0.lab")
    mono = os.path.join(wt, "labels", "mono", "utt0.lab")
    lf0 = rawio.read_f32(os.path.join(wj, "lf0", "utt0.lf0"), 2)[:, 0]
    got = vibrato.extract(lf0, labels.load_labels(mono, full), 5.0)
    want = jvibrato.extract(lf0, jlabels.load_labels(mono, full), 5.0)
    for g, w in zip(got, want):
        assert np.abs(g.astype(np.float64) - w).max() <= 1e-12


def test_compose_and_stats_match_jax(runs):
    """From identical stream files: cmp (HTK header and body) and ffo
    within tests/test_torch_pgen.py's compose_cmp tolerance (1e-6 of each
    column's scale; here byte for byte), STATS's variances likewise."""
    wj, wt, _, _ = runs
    for u in range(3):
        a, pa, ka = htk.read_htk(os.path.join(wt, "cmp", f"utt{u}.cmp"))
        b, pb, kb = jhtk.read_htk(os.path.join(wj, "cmp", f"utt{u}.cmp"))
        assert a.shape == b.shape == (121, 237) and (pa, ka) == (pb, kb)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * (
            1.0 + np.abs(b).max()))
        for sub, ext in (("cmp", "cmp"), ("ffo", "ffo")):
            assert filecmp.cmp(os.path.join(wt, sub, f"utt{u}.{ext}"),
                               os.path.join(wj, sub, f"utt{u}.{ext}"),
                               shallow=False)
    for name in ("ffo", "mgc", "lf0", "bap", "gv"):
        a = rawio.read_f32(os.path.join(wt, "stats", f"{name}.var"))
        b = rawio.read_f32(os.path.join(wj, "stats", f"{name}.var"))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_halgn_and_mkdat_equal_jax(runs):
    """From identical cmp inputs: labels/align and labels/fal text, and
    the ffi files, exactly equal; the duration model pickled as plain
    values."""
    wj, wt, _, p = runs
    for u in range(3):
        for sub, ext in (("labels/align", "lab"), ("labels/fal", "lab"),
                         ("ffi", "ffi")):
            a = os.path.join(wt, sub, f"utt{u}.{ext}")
            assert filecmp.cmp(a, os.path.join(wj, sub, f"utt{u}.{ext}"),
                               shallow=False), a
        ends = [int(ln.split()[1]) for ln in open(os.path.join(
            wt, "labels", "align", f"utt{u}.lab")).read().splitlines()]
        assert all(b >= a for a, b in zip(ends, ends[1:]))
        assert ends[-1] == 121 * 50000
    import pickle
    with open(os.path.join(wt, "model", "hmm.pkl"), "rb") as f:
        hmm = pickle.load(f)
    assert isinstance(hmm["clustered"], dict) and hmm["cfg"].n_states == 5
    assert p.manifest.done("MKDAT") and "IN_RE" in p.halgn_seconds
    assert sum(kernels.launches.values()) == 0


def test_soft_counts_part_the_packages_at_a_min_occupancy_tie(runs):
    """Why HALGN runs at hard counts above: the pipeline's default recipe
    (soft counts) on identical cmp frames, in both packages, builds a tree
    that splits by a question on one side of min_occupancy and not on the
    other, a note state's occupancy of 1.0 frame within 1e-9
    (chip_smoke.occupancy_ties, which phase 4 applies card vs CPU)."""
    wj, wt, _, p = runs
    corpus, spans = [], {}
    for b in p.utterances():
        ctx, ends = p._full_label(b)
        frames = p._read_cmp(b)
        spans[len(corpus)] = np.minimum(ends, len(frames))
        corpus.append((frames, ctx))
    conf = qconf.parse_config(QCONF)
    rcfg = dict(HALGN, soft_counts=True)
    with chip_smoke.recording_trees(jclustering) as jbuilt:
        jrecipe.train_voice(corpus, jclustering.questions_from_config(conf),
                            jrecipe.RecipeConfig(**rcfg),
                            streams=jhsmm.world_streams(),
                            bootstrap_spans=spans, log=lambda m: None)
    with chip_smoke.recording_trees(clustering) as pbuilt:
        recipe.train_voice(corpus, clustering.questions_from_config(conf),
                           recipe.RecipeConfig(**rcfg),
                           streams=hsmm.world_streams(),
                           bootstrap_spans=spans, log=lambda m: None,
                           device="cpu")
    assert chip_smoke.occupancy_ties(pbuilt, pbuilt, 1e-9) == (None, [])
    at, ties = chip_smoke.occupancy_ties(jbuilt, pbuilt, 1e-9)
    assert at is not None and len(ties) == 1
    assert ties[0]["question"].startswith("C-Note_")
    assert ties[0]["distance"] <= 1e-9


def test_run_raises_at_trdnn_after_mkdat(runs, tmp_path):
    """Past MKDAT the DNN half runs (tests/test_torch_pipeline_dnn.py);
    here TRDNN refuses an ffi file whose size is not a whole number of
    the question set's frames, leaving MKDAT done and TRDNN not; before
    any training synthesize_unseen finds no checkpoint; at parity=True
    ANALYZE runs per utterance in float64 (it raised before the port had
    parity analysis), its files of the run's frame counts and its lf0
    within 1e-3 of the fast path's (median over voiced frames)."""
    _, wt, _, _ = runs
    wd = str(tmp_path / "copy")
    shutil.copytree(wt, wd)
    ffi = os.path.join(wd, "ffi", "utt1.ffi")
    with open(ffi, "rb") as f:
        data = f.read()
    with open(ffi, "wb") as f:
        f.write(data[:-4])
    p = pl.SingingPipeline(pl.PipelineConfig(wd, fs=FS, use_hmm_align=True,
                                             device="cpu"))
    with pytest.raises(ValueError, match="reshape"):
        p.run()
    assert p.manifest.done("MKDAT") and not p.manifest.done("TRDNN")
    assert all(os.path.exists(p._p("ffi", f"utt{u}", "ffi"))
               for u in range(3))
    with pytest.raises(RuntimeError, match="no trained checkpoint"):
        p.synthesize_unseen("utt0")
    wp = str(tmp_path / "parity")
    os.makedirs(os.path.join(wp, "labels", "mono"))
    shutil.copytree(os.path.join(wt, "raw"), os.path.join(wp, "raw"))
    q = pl.SingingPipeline(pl.PipelineConfig(wp, fs=FS, parity=True,
                                             device="cpu"))
    q.analyze()
    assert q.manifest.done("ANALYZE")
    for u in range(3):
        fast = rawio.read_f32(p._p("lf0", f"utt{u}", "lf0"), 2)
        par = rawio.read_f32(q._p("lf0", f"utt{u}", "lf0"), 2)
        assert par.shape == fast.shape
        v = (fast[:, 0] > 0) & (par[:, 0] > 0)
        assert v.mean() > 0.5
        assert np.median(np.abs(par[v, 0] - fast[v, 0])) < 1e-3


def test_single_utterance_analyze_matches_the_batched_path(tmp_path):
    """One utterance goes through vocoder.analyze + encode_features, the
    corpus through bucketed_extract; both give the same files but for the
    last frame, whose CheapTrick window reaches past the signal's end
    (zeros of the bucket in the batched path)."""
    one, many = str(tmp_path / "one"), str(tmp_path / "many")
    make_corpus(many)
    make_corpus(one, n_utt=1)
    for wd in (one, many):
        pl.SingingPipeline(pl.PipelineConfig(
            wd, fs=FS, device="cpu")).run(upto="ANALYZE")
    for s, dim in (("lf0", 2), ("mgc", 50), ("bap", 25), ("vib", 2)):
        a = rawio.read_f32(os.path.join(one, s, f"utt0.{s}"), dim)
        b = rawio.read_f32(os.path.join(many, s, f"utt0.{s}"), dim)
        assert a.shape == b.shape == (121, dim)
        np.testing.assert_allclose(a[:-1], b[:-1], rtol=1e-5, atol=1e-5)
