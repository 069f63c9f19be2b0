"""The port's DSP (``kantts_tpu_torch/dsp``) and db3 DWT against the JAX
package, on numpy inputs from a seed. Tolerances: filterbanks and windows
atol 1e-7; STFT magnitudes rtol 1e-5 with atol 1e-6 (an FFT's float32
rounding is absolute, so the smallest bins need the atol); feature-extraction mels atol 1e-5; loss mels at the published
2048/200/1000 settings atol 1e-4; the DWT atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kantts_tpu.dsp import mel as jmel
from kantts_tpu.dsp import stft as jstft
from kantts_tpu.models.hifigan.discriminators import dwt1d_db3 as j_dwt
from kantts_tpu_torch.dsp import mel as tmel
from kantts_tpu_torch.dsp import stft as tstft
from kantts_tpu_torch.models.hifigan.discriminators import db3_filters, dwt1d_db3


def _wav(seed, *shape):
    return (0.3 * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (16000, 2048, 80, 0.0, 8000.0), (22050, 1024, 80, 80.0, 7600.0),
    (1600, 256, 20, 0.0, None)])
def test_mel_filterbank_matches_jax(sr, n_fft, n_mels, fmin, fmax):
    want = jmel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    got = tmel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert got.shape == (n_mels, n_fft // 2 + 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def test_windows_match_jax():
    for n in (128, 600, 1000):
        np.testing.assert_array_equal(tstft.hann_window(n), jstft.hann_window(n))
        np.testing.assert_array_equal(tstft.pad_center(tstft.hann_window(n), 2048),
                                      jstft.pad_center(jstft.hann_window(n), 2048))


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
@pytest.mark.parametrize("n_fft,hop,win", [(256, 64, 128), (1024, 120, 600)])
def test_stft_magnitude_matches_jax(pad_mode, n_fft, hop, win):
    x = _wav(0, 3, 2000)
    want = np.asarray(jstft.stft_magnitude(
        jnp.asarray(x), n_fft, hop, win, jnp.asarray(jstft.hann_window(win)),
        pad_mode=pad_mode))
    got = tstft.stft_magnitude(torch.from_numpy(x), n_fft, hop, win,
                               pad_mode=pad_mode).numpy()
    assert got.shape == want.shape == (3, 1 + 2000 // hop, n_fft // 2 + 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_mel_extractor_matches_jax():
    x = _wav(1, 2, 4000)
    args = (16000, 2048, 200, 1000, 80, 1.0, -100.0, 20.0, 0.0, 8000.0, False)
    want = jmel.MelSpectrogramExtractor(*args)(x)
    got = tmel.MelSpectrogramExtractor(*args)(x)
    assert got.shape == want.shape == (2, 21, 80)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_loss_mel_matches_jax():
    """hifigan_v1_16k's mel_loss settings; (B, 1, T) in, (B, n_mels, frames)
    out, in [-4, 4]."""
    x = _wav(2, 2, 1, 9600)
    kw = dict(fs=16000, fft_size=2048, hop_size=200, win_length=1000,
              num_mels=80, fmin=0, fmax=8000, log_base=None)
    want = np.asarray(jmel.LossMelSpectrogram(**kw)(jnp.asarray(x)))
    got = tmel.LossMelSpectrogram(**kw)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 80, 49)
    assert np.abs(got).max() <= 4.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("T", [128, 129, 9600])
def test_dwt_matches_jax(T):
    x = _wav(3, 2, T, 1)
    want_lo, want_hi = (np.asarray(a) for a in j_dwt(jnp.asarray(x)))
    lo, hi = dwt1d_db3(torch.from_numpy(x).transpose(1, 2), db3_filters())
    assert lo.shape == (2, 1, (T + 4) // 2 + 1)
    np.testing.assert_allclose(lo.numpy()[:, 0], want_lo[..., 0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(hi.numpy()[:, 0], want_hi[..., 0], atol=1e-6, rtol=0)
