"""The port's audio IO, DSP front end, feature embedders' shared parts and
the FFmpeg decoder vs the JAX package, on the CPU at a small size.

Bit-equal: ``load_clip`` (wav 8/16/32-bit, stereo, resampled, npy),
``resample_linear``, ``mel_filterbank``, ``hann_window``, ``dct_matrix``
and ``RandomFeatures`` (the same numpy on the same inputs).  rtol 1e-4 /
atol 1e-4: ``mel_power`` (center on and off, power 1 and 2, a window
shorter than n_fft), ``melspectrogram`` (short clips too) and MFCC; the
port's rfft runs in float64, JAX's in f32, so the bar is the JAX f32
rfft's own error.  Clips carry a seeded noise floor, as recorded audio
does: the log of a noiseless tone's far bands (power ~1e-12 of the peak)
is decided by an f32 rfft's rounding, in JAX as anywhere.  The decoder
tests mirror ``tests/test_audiodec.py`` through the port's own build and
skip only where the FFmpeg headers are absent.
"""

import json
import os
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu import features as JF
from gcn_song_embeddings_tpu_torch import features as F
from gcn_song_embeddings_tpu_torch.native import audiodec
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = {"rtol": 1e-4, "atol": 1e-4}


def _tone(freqs, seconds, sr, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    y = sum(a * np.sin(2 * np.pi * f * t) for f, a in freqs)
    y = y + 1e-3 * np.random.default_rng(seed).standard_normal(t.shape)
    return y.astype(np.float32)


def _write_wav(path, y, sr, width=2, channels=1):
    data = np.repeat(y[:, None], channels, axis=1).ravel()
    if width == 1:
        raw = np.clip(data * 127 + 128, 0, 255).astype(np.uint8)
    elif width == 2:
        raw = (data * 32767).astype(np.int16)
    else:
        raw = (data * 2147483000).astype(np.int32)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw.tobytes())


CLIP_CASES = {
    "wav8": dict(ext=".wav", width=1, sr=16000, seconds=1.0),
    "wav16": dict(ext=".wav", width=2, sr=16000, seconds=1.0),
    "wav32": dict(ext=".wav", width=4, sr=16000, seconds=1.0),
    "stereo": dict(ext=".wav", width=2, sr=16000, seconds=1.0, channels=2),
    "resampled": dict(ext=".wav", width=2, sr=22050, seconds=1.5),
    "long_cut": dict(ext=".wav", width=2, sr=8000, seconds=31.0),
    "npy": dict(ext=".npy", sr=16000, seconds=2.0),
    "npy_2d": dict(ext=".npy", sr=16000, seconds=2.0, channels=2),
}


@pytest.mark.parametrize("case", sorted(CLIP_CASES))
def test_load_clip_bit_equal(tmp_path, case):
    c = CLIP_CASES[case]
    y = _tone([(440.0, 0.5)], c["seconds"], c["sr"], seed=len(case))
    path = str(tmp_path / f"clip{c['ext']}")
    if c["ext"] == ".wav":
        _write_wav(path, y, c["sr"], c["width"], c.get("channels", 1))
    else:
        np.save(path, np.stack([y, -y], 1) if c.get("channels") else y)
    got, want = F.load_clip(path), JF.load_clip(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (F.CLIP_SAMPLES,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rates", [(8000, 16000), (22050, 16000),
                                   (44100, 48000), (16000, 48000)])
def test_resample_linear_bit_equal(rates):
    y = _tone([(330.0, 0.4), (2000.0, 0.2)], 0.7, rates[0])
    np.testing.assert_array_equal(F.resample_linear(y, *rates),
                                  JF.resample_linear(y, *rates))


@pytest.mark.parametrize("cfg", [(128, 2048, 16000, 0.0, None),
                                 (64, 512, 16000, 125.0, 7500.0),
                                 (96, 512, 16000, 0.0, None),
                                 (128, 2048, 48000, 0.0, None),
                                 (64, 1024, 16000, 0.0, None)])
def test_mel_filterbank_bit_equal(cfg):
    n_mels, n_fft, sr, fmin, fmax = cfg
    np.testing.assert_array_equal(
        F.mel_filterbank(n_mels, n_fft, sr, fmin=fmin, fmax=fmax),
        JF.mel_filterbank(n_mels, n_fft, sr, fmin=fmin, fmax=fmax))


@pytest.mark.parametrize("n", [16, 400, 1024, 2048])
def test_hann_window_bit_equal_and_periodic(n):
    np.testing.assert_array_equal(F.hann_window(n), JF.hann_window(n))
    np.testing.assert_allclose(F.hann_window(n), torch.hann_window(n),
                               atol=2e-7)


@pytest.mark.parametrize("shape", [(40, 128), (20, 128), (13, 40)])
def test_dct_matrix_bit_equal(shape):
    np.testing.assert_array_equal(F.dct_matrix(*shape),
                                  JF.dct_matrix(*shape))


@pytest.mark.parametrize("pad", [3, 512, 1500])
def test_reflect_pad_equals_numpy_for_any_pad(pad):
    x = np.random.default_rng(pad).normal(size=(2, 600)).astype(np.float32)
    got = F.reflect_pad(torch.from_numpy(x), pad).numpy()
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (pad, pad)),
                                              mode="reflect"))


MEL_CASES = {
    "center_power2": dict(center=True, power=2.0, win=None),
    "center_power1": dict(center=True, power=1.0, win=None),
    "uncentered_power2": dict(center=False, power=2.0, win=None),
    "uncentered_power1": dict(center=False, power=1.0, win=None),
    "short_window_power1": dict(center=False, power=1.0, win=400),
    "short_window_center": dict(center=True, power=2.0, win=400),
}


@pytest.mark.parametrize("case", sorted(MEL_CASES))
def test_mel_power_matches_jax(case):
    c = MEL_CASES[case]
    n_fft, hop, sr = 512, 160, 16000
    clips = np.stack([_tone([(440.0, 0.5)], 0.5, sr, seed=1),
                      _tone([(1760.0, 0.3), (95.0, 0.4)], 0.5, sr, seed=2)])
    fb = F.mel_filterbank(64, n_fft, sr, fmin=125.0, fmax=7500.0)
    win = np.hanning(c["win"]).astype(np.float32) if c["win"] \
        else F.hann_window(n_fft)
    got = F.mel_power(torch.from_numpy(clips), torch.from_numpy(fb),
                      torch.from_numpy(win), n_fft, hop, center=c["center"],
                      power=c["power"]).numpy()
    want = np.asarray(JF._mel_power(jnp.asarray(clips), jnp.asarray(fb),
                                    jnp.asarray(win), n_fft, hop,
                                    center=c["center"], power=c["power"]))
    assert got.shape == want.shape
    # the mel spectrum before any log: relative to its scale
    np.testing.assert_allclose(got / want.max(), want / want.max(), **TOL)
    np.testing.assert_allclose(np.log(got + 1e-2), np.log(want + 1e-2),
                               **TOL)


@pytest.mark.parametrize("kind", ["clip_30s", "short_600"])
def test_melspectrogram_matches_jax(kind):
    if kind == "clip_30s":
        clips = np.zeros((1, F.CLIP_SAMPLES), np.float32)
        clips[0, :16000] = _tone([(1000.0, 0.5)], 1.0, 16000)
        frames = 1 + F.CLIP_SAMPLES // 512
    else:
        clips = np.random.default_rng(1).normal(size=(2, 600)).astype(
            np.float32)
        frames = 1 + 600 // 512
    got = F.melspectrogram(clips, device=CPU)
    want = JF.melspectrogram(clips)
    assert got.shape == want.shape == (clips.shape[0], 64, frames)
    np.testing.assert_allclose(got, want, **TOL)


def test_melspectrogram_uncentered_refuses_short_clips():
    short = np.zeros((2, 600), np.float32)
    with pytest.raises(ValueError, match="too short"):
        F.melspectrogram(short, center=False, device=CPU)


def test_frontend_tables_built_once_per_config():
    a = F.frontend_tables(64, 1024, 16000, CPU)
    b = F.frontend_tables(64, 1024, 16000, CPU)
    assert a[0] is b[0] and a[1] is b[1]
    sym = F.frontend_tables(64, 512, 16000, CPU, win_length=400,
                            periodic=False)[1]
    np.testing.assert_array_equal(sym.numpy(),
                                  np.hanning(400).astype(np.float32))


@pytest.mark.parametrize("n_mfcc", [40, 13])
def test_mfcc_matches_jax(n_mfcc):
    sr = F.SAMPLE_RATE
    clips = np.stack([_tone([(220.0, 0.5)], 4.0, sr, seed=3),
                      _tone([(1760.0, 0.5), (440.0, 0.2)], 4.0, sr, seed=4)])
    got = F.MFCC(n_mfcc=n_mfcc, device=CPU).embed_batch(clips)
    want = JF.MFCC(n_mfcc=n_mfcc).embed_batch(clips)
    assert got.shape == want.shape == (2, n_mfcc)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got[0] - got[1]).max() > 0.1      # the tones separate


@pytest.mark.parametrize("dim,seed", [(512, 0), (32, 1)])
def test_random_features_bit_equal(dim, seed):
    port, jax_ = F.RandomFeatures(dim, seed), JF.RandomFeatures(dim, seed)
    for n in (4, 512, 3):
        np.testing.assert_array_equal(
            port.embed_batch(np.zeros((n, 10), np.float32)),
            jax_.embed_batch(np.zeros((n, 10), np.float32)))


def _clip_dataset(root, n, seconds=1.0):
    ds = root / "ds"
    os.makedirs(ds / "clips")
    tracks = {f"t{i}": {"name": f"s{i}", "artist": "a"} for i in range(n)}
    with open(ds / "tracks.json", "w") as f:
        json.dump(tracks, f)
    for i in range(n):
        y = _tone([(200.0 * (i + 1), 0.5)], seconds, 16000, seed=i)
        if i % 2:
            np.save(ds / "clips" / f"t{i}.npy", y)
        else:
            _write_wav(ds / "clips" / f"t{i}.wav", y, 16000)
    return ds


def test_generate_features_skip_list_and_parity(tmp_path):
    """Per-track files, the consolidated matrix in tracks.json order, the
    skip list (an existing per-track file is not recomputed), and the
    MFCC rows within 1e-4 of the JAX package's pipeline."""
    ds = _clip_dataset(tmp_path, 5)
    out_dir = F.generate_features(str(ds), F.MFCC(n_mfcc=8, device=CPU),
                                  verbose=False)
    mat = np.load(ds / "features_mfcc.npy")
    assert mat.shape == (5, 8)
    jdir = tmp_path / "jax_mfcc"
    JF.generate_features(str(ds), JF.MFCC(n_mfcc=8), out_dir=str(jdir),
                         verbose=False)
    np.testing.assert_allclose(mat, np.load(ds / "features_mfcc.npy"),
                               **TOL)
    np.save(ds / "features_mfcc.npy", mat)
    marker = np.full(8, 99.0, dtype=np.float32)
    np.save(os.path.join(out_dir, "t3.npy"), marker)
    F.generate_features(str(ds), F.MFCC(n_mfcc=8, device=CPU),
                        verbose=False)
    np.testing.assert_array_equal(np.load(os.path.join(out_dir, "t3.npy")),
                                  marker)
    np.testing.assert_array_equal(np.load(ds / "features_mfcc.npy")[3],
                                  marker)


def test_generate_features_random_bit_equal_with_a_missing_clip(tmp_path):
    ds = _clip_dataset(tmp_path, 7)
    os.remove(ds / "clips" / "t2.wav")          # zero-filled, still a row
    F.generate_features(str(ds), F.RandomFeatures(16, seed=5),
                        batch_size=3, verbose=False)
    port = np.load(ds / "features_random.npy")
    JF.generate_features(str(ds), JF.RandomFeatures(16, seed=5),
                         batch_size=3, out_dir=str(tmp_path / "j"),
                         verbose=False)
    np.testing.assert_array_equal(port, np.load(ds / "features_random.npy"))


def test_compressed_clip_without_a_decoder_names_the_fix(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(audiodec, "native_available", lambda: False)
    with pytest.raises(ValueError, match="native decoder"):
        F.load_clip(str(tmp_path / "clip.mp3"))


# ------------------------------------------------- the FFmpeg decoder


@pytest.fixture
def decoder():
    if not audiodec.native_available():
        pytest.skip("the FFmpeg development headers are absent: the native "
                    "decoder is not built here")
    return audiodec


def _peak_freq(y, sr):
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    return float(np.fft.rfftfreq(len(y), 1.0 / sr)[spec.argmax()])


def test_a_copied_library_that_fails_to_load_is_built_again(decoder,
                                                           monkeypatch):
    """A decoder built on another machine whose FFmpeg this one lacks
    (dlopen fails) is deleted and built here."""
    from gcn_song_embeddings_tpu_torch.native import build

    path = build.build("audiodec")
    real = build.ctypes.CDLL
    opened = []

    def cdll(name, *args, **kwargs):
        opened.append(name)
        if len(opened) == 1:
            raise OSError("libavformat.so.0: cannot open shared object file")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(build, "_libs", {})
    assert build.library("audiodec") is not None
    assert opened == [str(path), str(path)] and path.is_file()


def test_mp3_roundtrip_spectral(tmp_path, decoder):
    sr = 44_100
    t = np.arange(2 * sr) / sr
    y = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    path = str(tmp_path / "tone.mp3")
    decoder.encode_mp3(path, y, sr)
    assert os.path.getsize(path) > 1000
    d = decoder.decode(path, 16_000)
    assert d.dtype == np.float32
    assert abs(len(d) - 2 * 16_000) < 0.05 * 2 * 16_000
    assert _peak_freq(d, 16_000) == pytest.approx(440.0, abs=2.0)
    assert np.sqrt((d ** 2).mean()) == pytest.approx(0.354, abs=0.03)
    d2 = decoder.decode(path, sr)
    assert abs(len(d2) - len(y)) < 0.05 * len(y)
    assert _peak_freq(d2, sr) == pytest.approx(440.0, abs=2.0)


def test_decoder_downmixes_stereo(tmp_path, decoder):
    sr = 22_050
    y = _tone([(330.0, 0.5)], 1.0, sr)
    path = str(tmp_path / "stereo.wav")
    _write_wav(path, y, sr, channels=2)
    d = decoder.decode(path, sr)
    assert abs(len(d) - sr) <= 2
    assert _peak_freq(d, sr) == pytest.approx(330.0, abs=2.0)


def test_load_clip_mp3_into_mfcc(tmp_path, decoder):
    sr = 32_000
    t = np.arange(3 * sr) / sr
    path = str(tmp_path / "clip0.mp3")
    decoder.encode_mp3(path, (0.5 * np.sin(2 * np.pi * 523.25 * t))
                       .astype(np.float32), sr)
    y = F.load_clip(path)
    assert y.shape == (F.CLIP_SAMPLES,) and y.dtype == np.float32
    assert np.abs(y[: 2 * F.SAMPLE_RATE]).max() > 0.2
    assert np.abs(y[-F.SAMPLE_RATE:]).max() == 0.0
    assert _peak_freq(y[: 2 * F.SAMPLE_RATE], F.SAMPLE_RATE) == \
        pytest.approx(523.25, abs=3.0)
    feats = F.MFCC(n_mfcc=20, device=CPU).embed_batch(y[None, :])
    assert feats.shape == (1, 20) and np.isfinite(feats).all()


def test_decode_error_paths(tmp_path, decoder):
    bad = tmp_path / "not_audio.mp3"
    bad.write_bytes(b"this is not an mp3 file at all" * 10)
    with pytest.raises(ValueError, match="decode failed"):
        decoder.decode(str(bad), 16_000)
    with pytest.raises(ValueError):
        decoder.decode(str(tmp_path / "missing.mp3"), 16_000)
