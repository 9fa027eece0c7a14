"""The port's data pipeline: ``SyntheticTokens`` equal to the JAX
package's bit for bit for every family (tokens, and the vlm and audio
families' patches and frames) across ``seek``, and the counterparts of
tests/test_data.py, with the one-device ``DeviceLoader`` in place of the
mesh loader."""
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import data as jdata
from repro_torch import configs as tconfigs
from repro_torch.data import DeviceLoader, SyntheticTokens

ARCHS = ["qwen1.5-4b", "internlm2-20b", "paligemma-3b", "arctic-480b", "kimi-k2-1t-a32b",
         "falcon-mamba-7b", "recurrentgemma-2b", "whisper-tiny", "granite-34b",
         "codeqwen1.5-7b"]


def cfg():
    return tconfigs.reduced(tconfigs.get_config("granite-34b"))


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stream_equals_jax_bitwise_across_seek(arch, full):
    """Three batches, a seek back to cursor 1 and on: every leaf equal to
    the JAX stream's, dtype and bits."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if not full:
        jcfg, tcfg = jconfigs.reduced(jcfg), tconfigs.reduced(tcfg)
    b, s = (2, 8) if full else (3, 16)
    js, ts = jdata.SyntheticTokens(jcfg, b, s, seed=7), SyntheticTokens(tcfg, b, s, seed=7)
    seq = []
    for _ in range(3):
        seq.append((next(js), next(ts)))
    js.seek(1)
    ts.seek(1)
    seq.append((next(js), next(ts)))
    assert ts.state() == js.state() == {"seed": 7, "cursor": 2}
    for jb, tb in seq:
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k]), k


def test_deterministic_given_seed():
    a = next(iter(SyntheticTokens(cfg(), 4, 8, seed=5)))
    b = next(iter(SyntheticTokens(cfg(), 4, 8, seed=5)))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_seek_resumes_exact_stream():
    ds1 = SyntheticTokens(cfg(), 2, 8, seed=1)
    seq = [next(ds1)["tokens"] for _ in range(5)]
    ds2 = SyntheticTokens(cfg(), 2, 8, seed=1)
    ds2.seek(3)
    np.testing.assert_array_equal(next(ds2)["tokens"], seq[3])
    np.testing.assert_array_equal(next(ds2)["tokens"], seq[4])


def test_tokens_in_vocab_range():
    c = cfg()
    batch = next(iter(SyntheticTokens(c, 8, 64, seed=2)))
    assert batch["tokens"].min() >= 0
    assert batch["tokens"].max() < c.vocab


def test_modality_stubs_present():
    vlm = tconfigs.reduced(tconfigs.get_config("paligemma-3b"))
    b = next(iter(SyntheticTokens(vlm, 2, 8)))
    assert b["patches"].shape == (2, vlm.n_patches, vlm.d_model)
    audio = tconfigs.reduced(tconfigs.get_config("whisper-tiny"))
    b = next(iter(SyntheticTokens(audio, 2, 8)))
    assert b["frames"].shape == (2, audio.enc_frames, audio.d_model)


def test_device_loader_preserves_order_and_content():
    c = cfg()
    src = SyntheticTokens(c, 2, 8, seed=9)
    want = [next(src)["tokens"] for _ in range(3)]
    loader = DeviceLoader(SyntheticTokens(c, 2, 8, seed=9), "cpu")
    got = [next(loader)["tokens"].numpy() for _ in range(3)]
    loader.close()
    assert not loader._thread.is_alive()  # close() stops the prefetch thread
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_device_loader_ends_with_its_source():
    c = cfg()
    loader = DeviceLoader(iter([next(SyntheticTokens(c, 2, 8, seed=s)) for s in range(3)]),
                          "cpu")
    assert len(list(loader)) == 3
    loader.close()
