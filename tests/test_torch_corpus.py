"""The port's corpus driver and pipelined cascade (zen_tpu_torch/drivers/
corpus.py, pipeline.py) against zen_tpu's, on the CPU.

Small configs (fs 1000, hops 16/8, as tests/test_runtime.py). zen_tpu
runs on ``make_mesh({"dp": 1 or 2, "sp": 1})``, the port on the CPU mesh
of the same shape (``make_mesh(..., device="cpu")``). Tolerances, each
with its reason:
* stems against zen_tpu: atol = 5e-5 x max(1, max|ref|) per stem
  (tests/test_torch_offline.py's class: only the FFTs round differently).
  The writers capture the raw stems: ``peak_normalize`` is patched to the
  identity in both packages, so the class applies before normalization.
* port against port (prefetch, pp, blocked routing, the pipeline against
  ``process``): bitwise, one package and one arithmetic;
* file names, journal keys, journal lines and result counts: equal.
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zen_tpu.io.audio as jaudio  # noqa: E402
from zen_tpu.drivers import corpus as jcorpus  # noqa: E402
from zen_tpu.drivers.pipeline import PipelinedHPRIOffline as JPipe  # noqa: E402
from zen_tpu.parallel.mesh import make_mesh  # noqa: E402
import zen_tpu_torch as T  # noqa: E402
import zen_tpu_torch.io.audio as taudio  # noqa: E402
from zen_tpu_torch.drivers import corpus as tcorpus  # noqa: E402
from zen_tpu_torch.drivers import offline as toff  # noqa: E402
from zen_tpu_torch.drivers import pipeline as tpipe  # noqa: E402
from zen_tpu_torch.io.audio import peak_normalize, read_audio_mono, write_audio_pcm16  # noqa: E402
from zen_tpu_torch.parallel import mesh as tmesh  # noqa: E402

ATOL = 5e-5
FS = 1000
HOPS = dict(hop_h=16, hop_p=8)
STEMS = ("harm", "perc", "residual")


def _audio(n, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=ATOL, err_msg=what)


def _capture():
    out = {}

    def writer(p, fs, a):
        out[p] = (fs, np.array(a, np.float32))

    return out, writer


def _cpu_mesh(dp=1, sp=1):
    return tmesh.make_mesh({"dp": dp, "sp": sp}, device="cpu")


def _port(paths, out_dir, store, dp=1, **kw):
    out, writer = _capture()
    res = tcorpus.separate_corpus(paths, str(out_dir), _cpu_mesh(dp), reader=lambda p: store[p],
                                  writer=writer, **{**HOPS, **kw})
    return res, out


def _jax(paths, out_dir, store, dp=1, **kw):
    out, writer = _capture()
    res = jcorpus.separate_corpus(paths, str(out_dir), make_mesh({"dp": dp, "sp": 1}),
                                  reader=lambda p: store[p], writer=writer, **{**HOPS, **kw})
    return res, out


@pytest.fixture
def raw_stems(monkeypatch):
    """Both packages' writers see the raw stems."""
    monkeypatch.setattr(jaudio, "peak_normalize", lambda x: x)
    monkeypatch.setattr(taudio, "peak_normalize", lambda x: x)


def _journal(path) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.parametrize("dp", [1, 2])
def test_corpus_matches_zen_tpu(tmp_path, raw_stems, dp):
    """Five tracks of different lengths, batched dp at a time: the same
    stem paths, sample rates, stems within the class, journal lines and
    counts as zen_tpu's corpus on a dp x 1 mesh."""
    store = {str(tmp_path / f"t{i}.wav"): (FS, _audio(300 + 40 * i, i)) for i in range(5)}
    paths = sorted(store)
    res_t, got = _port(paths, tmp_path / "port", store, dp=dp)
    res_j, want = _jax(paths, tmp_path / "jax", store, dp=dp)
    assert res_t == res_j == {"done": 0, "processed": 5}
    rename = {p.replace(str(tmp_path / "jax"), str(tmp_path / "port")): v for p, v in want.items()}
    assert got.keys() == rename.keys() and len(got) == 15
    for p, (fs, x) in got.items():
        assert fs == rename[p][0] == FS
        _close(x, rename[p][1], p)
    assert _journal(tmp_path / "port" / "progress.jsonl") == _journal(
        tmp_path / "jax" / "progress.jsonl")


def test_corpus_batch_masks_each_track(tmp_path, raw_stems):
    """A track's stems do not depend on the longer tracks sharing its
    batch: dp=2 equals dp=1 per track within the class (the batch only
    changes the FFT's batch), and process() with ``lengths`` equals the
    per-track process() on each row's own length."""
    store = {str(tmp_path / f"t{i}.wav"): (FS, _audio(n, i)) for i, n in enumerate((250, 400, 333))}
    paths = sorted(store)
    _, one = _port(paths, tmp_path / "a", store, dp=1)
    _, two = _port(paths, tmp_path / "b", store, dp=3)
    for p, (_, x) in one.items():
        _close(two[p.replace(str(tmp_path / "a"), str(tmp_path / "b"))][1], x, p)
    sep = T.HPRIOffline(FS, 16, 8, device="cpu")
    batch = np.zeros((3, 400), np.float32)
    for row, p in zip(batch, paths):
        row[: len(store[p][1])] = store[p][1]
    stems = sep.process(batch, lengths=[len(store[p][1]) for p in paths])
    for j, p in enumerate(paths):
        n = len(store[p][1])
        for got, want in zip(stems, sep.process(store[p][1])):
            _close(got[j, :n].numpy(), want.numpy(), p)


def test_process_of_one_row_equals_one_track():
    """The corpus's dp=1 batch [1, L] and a lone track [L] run the same
    arithmetic: bitwise."""
    x = _audio(431, 5)
    sep = T.HPRIOffline(FS, 16, 8, device="cpu")
    for a, b in zip(sep.process(x[None], lengths=[431]), sep.process(x)):
        assert torch.equal(a[0], b)


def test_corpus_writes_files_resumes_and_default_device(tmp_path):
    """Real files through the default reader and writer: stems equal to
    the port's writer over process(); a rerun processes nothing; the
    default mesh is over the cards (refused here with a ZenError)."""
    paths = []
    for i in range(3):
        p = tmp_path / f"track{i}.wav"
        write_audio_pcm16(str(p), FS, peak_normalize(_audio(400 + 16 * i, i)))
        paths.append(str(p))
    out = tmp_path / "stems"
    res = tcorpus.separate_corpus(paths, str(out), _cpu_mesh(dp=2), **HOPS)
    assert res == {"done": 0, "processed": 3}
    sep = T.HPRIOffline(FS, 16, 8, device="cpu")
    for i, p in enumerate(paths):
        fs, x = read_audio_mono(p)
        for name, stem in zip(STEMS, sep.process(x)):
            write_audio_pcm16(str(tmp_path / "ref.wav"), fs, peak_normalize(stem.numpy()))
            got = (out / f"track{i}_{name}.wav").read_bytes()
            assert got == (tmp_path / "ref.wav").read_bytes(), (p, name)
    assert tcorpus.separate_corpus(paths, str(out), _cpu_mesh(), **HOPS) == {
        "done": 3, "processed": 0}
    if not torch.cuda.is_available():
        with pytest.raises(T.ZenError, match="device"):
            tcorpus.separate_corpus(paths, str(tmp_path / "x"), **HOPS)


def test_corpus_mixed_sample_rates(tmp_path):
    """Tracks of different sample rates never share a batch: every stem
    is written at its own track's rate, as zen_tpu does."""
    rng = np.random.default_rng(0)
    store = {str(tmp_path / f"t{i}.wav"): (fs, rng.standard_normal(640).astype(np.float32))
             for i, fs in enumerate((1000, 2000, 1000, 2000))}
    calls = []
    orig = tcorpus.sharded_hpri_offline

    def spy(audio, cfg_h, cfg_p, mesh, lengths=None):
        calls.append((cfg_h.fs, list(lengths)))
        return orig(audio, cfg_h, cfg_p, mesh, lengths=lengths)

    tcorpus.sharded_hpri_offline = spy
    try:
        res, got = _port(list(store), tmp_path / "out", store, dp=2)
    finally:
        tcorpus.sharded_hpri_offline = orig
    _, want = _jax(list(store), tmp_path / "jout", store, dp=2)
    assert res["processed"] == 4
    # each batch of one track, padded to the dp rows with an empty one
    assert calls == [(1000.0, [640, 0]), (2000.0, [640, 0]), (1000.0, [640, 0]),
                     (2000.0, [640, 0])]
    for p, (fs, _) in store.items():
        base = os.path.basename(p)[:-4]
        for stem in STEMS:
            assert got[str(tmp_path / "out" / f"{base}_{stem}.wav")][0] == fs
            assert want[str(tmp_path / "jout" / f"{base}_{stem}.wav")][0] == fs


def test_corpus_basename_collision(tmp_path):
    """Tracks sharing a basename in different directories get zen_tpu's
    sha1-suffixed stem names, none written twice."""
    rng = np.random.default_rng(1)
    store = {str(tmp_path / d / "track.wav"): (FS, rng.standard_normal(400).astype(np.float32))
             for d in ("a", "b")}
    res, got = _port(list(store), tmp_path / "out", store)
    _, want = _jax(list(store), tmp_path / "jout", store)
    assert res["processed"] == 2 and len(got) == 6
    assert sorted(got) == sorted(p.replace("/jout/", "/out/") for p in want)
    assert all("track-" in os.path.basename(p) for p in got)


def test_corpus_long_track_routes_to_checkpointed_blocked(tmp_path, monkeypatch):
    """A track past LONG_TRACK_SAMPLES takes the checkpointed
    process_blocked (<out>/.ckpt, tag = its stem base) and its stems
    equal process_blocked()'s bitwise; the short one stays batched; the
    checkpoint files are gone once the journal holds the track. zen_tpu
    on a dp x 1 mesh routes the same track the same way (within the
    class)."""
    monkeypatch.setattr(toff, "LONG_TRACK_SAMPLES", 1000)
    import zen_tpu.drivers.offline as joff

    monkeypatch.setattr(joff, "LONG_TRACK_SAMPLES", 1000)
    monkeypatch.setattr(jaudio, "peak_normalize", lambda x: x)
    monkeypatch.setattr(taudio, "peak_normalize", lambda x: x)
    long_audio, short_audio = _audio(4000, 4, 0.4), _audio(500, 5, 0.4)
    store = {str(tmp_path / "long.wav"): (FS, long_audio),
             str(tmp_path / "short.wav"): (FS, short_audio)}
    calls = []
    orig = T.HPRIOffline.process_blocked

    def spy(self, audio, **kw):
        calls.append(kw)
        return orig(self, audio, **kw)

    monkeypatch.setattr(T.HPRIOffline, "process_blocked", spy)
    res, got = _port(list(store), tmp_path / "out", store, dp=2)
    assert res["processed"] == 2
    assert calls == [{"ckpt_dir": str(tmp_path / "out" / ".ckpt"), "tag": "long"}]
    assert os.listdir(tmp_path / "out" / ".ckpt") == []
    want = orig(T.HPRIOffline(FS, 16, 8, device="cpu"), long_audio)
    for stem, w in zip(STEMS, want):
        np.testing.assert_array_equal(got[str(tmp_path / "out" / f"long_{stem}.wav")][1],
                                      w.numpy(), err_msg=stem)
    _, jwant = _jax(list(store), tmp_path / "jout", store, dp=2)
    for p, (_, x) in got.items():
        _close(x, jwant[p.replace(str(tmp_path / "out"), str(tmp_path / "jout"))][1], p)


def test_corpus_sweeps_leaked_checkpoints_of_done_tracks(tmp_path):
    """Checkpoint files of a journal-done track (a crash between its
    journal fsync and the cleanup) are removed when the corpus starts."""
    rng = np.random.default_rng(14)
    store = {str(tmp_path / f"t{i}.wav"): (FS, rng.standard_normal(300).astype(np.float32))
             for i in range(2)}
    out = tmp_path / "out"
    run = lambda: tcorpus.separate_corpus(  # noqa: E731
        sorted(store), str(out), _cpu_mesh(), reader=lambda p: store[p],
        writer=lambda p, fs, a: None, **HOPS)
    run()
    ckpt_dir = out / ".ckpt"
    ckpt_dir.mkdir(exist_ok=True)
    leaked = [ckpt_dir / "t0.p1.stems.f32", ckpt_dir / "t0.p2.ckpt.npz"]
    for f in leaked:
        f.write_bytes(b"x" * 64)
    res = run()
    assert res == {"done": 2, "processed": 0}
    assert not any(f.exists() for f in leaked)


def test_corpus_pp_routes_through_the_pipeline(tmp_path):
    """``pp=True``: the pipelined cascade is what ran, its stems equal the
    plain run's bitwise (the same two passes), and the journal resumes."""
    store = {str(tmp_path / f"t{i}.wav"): (FS, _audio(300 + 8 * i, i)) for i in range(4)}
    paths = sorted(store)
    calls = []
    orig = tpipe.PipelinedHPRIOffline.process_stream

    def counting(self, tracks, prefetch=2):
        calls.append(len(tracks))
        return orig(self, tracks, prefetch)

    tpipe.PipelinedHPRIOffline.process_stream = counting
    try:
        res, pp = _port(paths, tmp_path / "pp", store, pp=True, pp_run=3)
    finally:
        tpipe.PipelinedHPRIOffline.process_stream = orig
    assert res["processed"] == 4 and calls == [3, 1]
    _, plain = _port(paths, tmp_path / "plain", store)
    for p, (_, x) in pp.items():
        np.testing.assert_array_equal(x, plain[p.replace("/pp/", "/plain/")][1], err_msg=p)
    res2, again = _port(paths, tmp_path / "pp", store, pp=True)
    assert res2 == {"done": 4, "processed": 0} and not again


@pytest.mark.parametrize("fmt", ["wav", "flac"])
@pytest.mark.parametrize("first", ["zen_tpu", "port"])
def test_corpus_journal_resumes_across_packages(tmp_path, first, fmt):
    """A journal either package wrote resumes in the other with nothing to
    do, for bare (wav) and suffixed (flac) keys; a journal of wav stems
    does not satisfy a flac run."""
    store = {str(tmp_path / f"t{i}.wav"): (FS, _audio(300, i)) for i in range(3)}
    paths = sorted(store)
    out = tmp_path / "out"
    runs = {"zen_tpu": _jax, "port": _port}
    second = "port" if first == "zen_tpu" else "zen_tpu"
    res, _ = runs[first](paths, out, store, stem_format=fmt)
    assert res == {"done": 0, "processed": 3}
    ids = [line["id"] for line in _journal(out / "progress.jsonl")]
    assert ids == [p if fmt == "wav" else f"{p}::{fmt}" for p in paths]
    assert [tcorpus.journal_key(p, fmt) for p in paths] == ids
    res, written = runs[second](paths, out, store, stem_format=fmt)
    assert res == {"done": 3, "processed": 0} and not written
    other = "flac" if fmt == "wav" else "wav"
    res, written = runs[second](paths, out, store, stem_format=other)
    assert res == {"done": 0, "processed": 3}
    assert all(p.endswith(f".{other}") for p in written)


def test_pipeline_matches_process_and_zen_tpu():
    """PipelinedHPRIOffline yields process()'s stems bitwise (the same two
    hpr_separate calls) and zen_tpu's pipeline's within the class."""
    sep = T.HPRIOffline(FS, 16, 8, device="cpu")
    pipe = tpipe.PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, device="cpu")
    tracks = [_audio(300 + 16 * s, s) for s in range(3)]
    got = list(pipe.process_stream(tracks))
    assert len(got) == 3
    import zen_tpu as J

    jsep = J.HPRIOffline(FS, 16, 8, 2.0, 2.0)
    want = list(JPipe(jsep.cfg_h, jsep.cfg_p).process_stream(tracks))
    for audio, g, w in zip(tracks, got, want):
        for a, b, c in zip(g, sep.process(audio), w):
            assert torch.equal(a, b)
            _close(a.numpy(), np.asarray(c), "pipeline vs zen_tpu")


def _slow_passes(monkeypatch, delay):
    """Make each pass of the pipelined cascade sleep ``delay`` first
    (releasing the interpreter lock, as a card's work does)."""
    real = tpipe.hpr_separate

    def slow(audio, cfg):
        time.sleep(delay)
        return real(audio, cfg)

    monkeypatch.setattr(tpipe, "hpr_separate", slow)


def _serial_wall(sep, tracks) -> float:
    """The same slowed passes, one after another in this thread: the
    wall the pipeline must beat, measured under the same load."""
    t0 = time.perf_counter()
    for audio in tracks:
        p1 = tpipe.hpr_separate(torch.from_numpy(audio), sep.cfg_h)
        p2 = tpipe.hpr_separate(p1["percussive"] + p1["residual"], sep.cfg_p)
        [x.numpy() for x in (p1["harmonic"], p2["percussive"], p2["residual"])]
    return time.perf_counter() - t0


def test_pipeline_stages_actually_overlap(monkeypatch):
    """Measured overlap, not just parity: each pass sleeps ``delay``, so n
    tracks take ~(n+1) delays pipelined against 2n in series. Both passes
    are warmed outside the clock, and the series is measured in this
    test on the same slowed passes (at least 2n delays)."""
    delay = 0.25
    _slow_passes(monkeypatch, delay)
    sep = T.HPRIOffline(FS, 16, 8, device="cpu")
    pipe = tpipe.PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, device="cpu")
    tracks = [_audio(256, s) for s in range(4)]
    list(pipe.process_stream(tracks[:1]))  # warm: both passes, outside the clock
    t0 = time.perf_counter()
    outs = [tuple(x.numpy() for x in o) for o in pipe.process_stream(tracks)]
    wall = time.perf_counter() - t0
    assert len(outs) == 4
    serial = _serial_wall(sep, tracks)
    assert serial >= 2 * len(tracks) * delay
    assert wall < 0.8 * serial, f"no overlap: wall {wall:.2f}s vs serial {serial:.2f}s"


def test_corpus_pp_overlap_is_real(tmp_path, monkeypatch):
    """The same bound through ``separate_corpus(pp=True)``, warmed on a
    track of its own."""
    delay = 0.25
    _slow_passes(monkeypatch, delay)
    store = {str(tmp_path / f"t{i}.wav"): (FS, _audio(256, i)) for i in range(5)}
    paths = sorted(store)
    _port(paths[4:], tmp_path / "warm", store, pp=True)
    t0 = time.perf_counter()
    res, _ = _port(paths[:4], tmp_path / "out", store, pp=True)
    wall = time.perf_counter() - t0
    assert res["processed"] == 4
    serial = _serial_wall(T.HPRIOffline(FS, 16, 8, device="cpu"),
                          [store[p][1] for p in paths[:4]])
    assert serial >= 2 * 4 * delay
    assert wall < 0.8 * serial, f"corpus pp shows no overlap: {wall:.2f}s vs serial {serial:.2f}s"


def test_pipeline_forwards_errors_and_stops_the_worker():
    """A failing track raises at the consumer after the tracks before it
    were yielded; a consumer that stops early leaves no worker behind."""
    sep = T.HPRIOffline(FS, 16, 8, device="cpu")
    pipe = tpipe.PipelinedHPRIOffline(sep.cfg_h, sep.cfg_p, device="cpu")

    def tracks():
        yield _audio(200, 0)
        raise OSError("decode failed")

    got = []
    with pytest.raises(OSError, match="decode failed"):
        for out in pipe.process_stream(tracks()):
            got.append(out)
    assert len(got) == 1
    import threading

    before = threading.active_count()
    gen = pipe.process_stream([_audio(200, s) for s in range(6)], prefetch=1)
    next(gen)
    gen.close()
    assert threading.active_count() <= before


def test_launch_counters_count_every_launch_from_many_threads():
    """The pipelined cascade launches kernels from two threads: the
    wrappers' counters take each launch under a lock, so none is lost to
    an interleaved read-modify-write (more threads than cores, a short
    switch interval)."""
    import sys
    import threading

    from zen_tpu_torch.ops import median_cuda as mc

    def wrapper():
        pass

    wrapper.launches, wrapper.routes = 0, {"register": 0}
    with mc._COUNT_LOCK:  # a count waits for the lock
        t = threading.Thread(target=mc._count, args=(wrapper, "register"))
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive() and wrapper.launches == 0
    t.join(timeout=10)
    assert not t.is_alive() and wrapper.launches == 1
    wrapper.launches, wrapper.routes = 0, {"register": 0}
    n_threads, n = 4 * (os.cpu_count() or 1), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [mc._count(wrapper, "register")
                                                    for _ in range(n)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == wrapper.routes["register"] == n_threads * n


def test_corpus_long_track_on_an_sp_mesh_takes_the_sharded_scan(tmp_path, monkeypatch):
    """On a mesh with sp > 1 a track past LONG_TRACK_SAMPLES x sp takes the
    checkpointed sharded_hpri_blocked (<out>/.ckpt, tag = its stem base),
    bitwise to process_blocked(); a track between LONG_TRACK_SAMPLES and
    that stays batched; .ckpt is empty after; zen_tpu's corpus on the
    same mesh shape within the class."""
    import zen_tpu.drivers.offline as joff

    monkeypatch.setattr(toff, "LONG_TRACK_SAMPLES", 1000)
    monkeypatch.setattr(joff, "LONG_TRACK_SAMPLES", 1000)
    monkeypatch.setattr(jaudio, "peak_normalize", lambda x: x)
    monkeypatch.setattr(taudio, "peak_normalize", lambda x: x)
    store = {str(tmp_path / "long.wav"): (FS, _audio(4000, 6, 0.4)),
             str(tmp_path / "mid.wav"): (FS, _audio(1500, 7, 0.4))}
    calls = []
    orig = tcorpus.sharded_hpri_blocked

    def spy(audio, cfg_h, cfg_p, mesh, **kw):
        calls.append((len(audio), kw))
        return orig(audio, cfg_h, cfg_p, mesh, **kw)

    monkeypatch.setattr(tcorpus, "sharded_hpri_blocked", spy)
    out, writer = _capture()
    res = tcorpus.separate_corpus(sorted(store), str(tmp_path / "out"), _cpu_mesh(sp=2),
                                  reader=lambda p: store[p], writer=writer, **HOPS)
    assert res["processed"] == 2
    assert calls == [(4000, {"ckpt_dir": str(tmp_path / "out" / ".ckpt"), "tag": "long"})]
    assert os.listdir(tmp_path / "out" / ".ckpt") == []
    want = T.HPRIOffline(FS, 16, 8, device="cpu").process_blocked(store[str(tmp_path / "long.wav")][1])
    for stem, w in zip(STEMS, want):
        np.testing.assert_array_equal(out[str(tmp_path / "out" / f"long_{stem}.wav")][1],
                                      w.numpy(), err_msg=stem)
    jout, jwriter = _capture()
    jcorpus.separate_corpus(sorted(store), str(tmp_path / "jout"), make_mesh({"dp": 1, "sp": 2}),
                            reader=lambda p: store[p], writer=jwriter, **HOPS)
    for p, (_, x) in out.items():
        _close(x, jout[p.replace(str(tmp_path / "out"), str(tmp_path / "jout"))][1], p)
