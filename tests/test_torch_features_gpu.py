"""The audio front ends, MFCC and the three nets on the card against the
port's own CPU path.

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_features_gpu.py

Tolerances: the mel front ends rtol 1e-4 / atol 1e-4 (atol 1e-3 for
OpenL3's dB mel), MFCC and the embeddings rtol 1e-3 / atol 1e-3, with
TF32 left on for the caller (the nets turn it off for themselves).
"""

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch import features as F
from gcn_song_embeddings_tpu_torch.models import audio_embedders as ae

pytestmark = pytest.mark.gpu
CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (these compare the card with the "
                    "CPU)")
    return torch.device("cuda")


def _clips(seconds, n=2, seed=0):
    sr = F.SAMPLE_RATE
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    return np.stack([0.5 * np.sin(2 * np.pi * 220 * (i + 1) * t)
                     + 1e-3 * rng.normal(size=t.shape)
                     for i in range(n)]).astype(np.float32)


FRONTENDS = {"openl3": (ae.openl3_mel_windows, 1e-3),
             "vggish": (ae.vggish_log_mel_patches, 1e-4),
             "musicnn": (ae.musicnn_log_mel_patches, 1e-4)}


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_frontend_on_the_card_equals_the_cpu(cuda, name):
    fn, atol = FRONTENDS[name]
    clips = _clips(30.0, seed=1)
    got, n = fn(clips, device=cuda)
    want, n_cpu = fn(clips, device=CPU)
    assert n == n_cpu
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=atol)


def test_mfcc_and_melspectrogram_on_the_card_equal_the_cpu(cuda):
    clips = _clips(30.0, n=3, seed=2)
    np.testing.assert_allclose(F.MFCC(device=cuda).embed_batch(clips),
                               F.MFCC(device=CPU).embed_batch(clips),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(F.melspectrogram(clips[:, :600], device=cuda),
                               F.melspectrogram(clips[:, :600], device=CPU),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["openl3", "vggish", "musicnn"])
def test_embedder_on_the_card_equals_the_cpu(cuda, name):
    cls = {"openl3": F.OpenL3, "vggish": F.VGGish, "musicnn": F.MusicNN}[name]
    clips = _clips(30.0, seed=3)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = cls(seed=0, device=cuda)
        got = card.embed_batch(clips)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    want = cls(seed=0, device=CPU).embed_batch(clips)
    assert got.shape == want.shape == (2, card.dim)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
