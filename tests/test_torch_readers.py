"""The port's event readers against the JAX package's.

Written ``t x y p`` streams, plain and zipped, with a ``width height``
header, malformed lines (too few and too many fields, blank), a
``start_index``, a partial last window and duration cutoffs: every window
of ``FixedSizeEventReader`` and ``FixedDurationEventReader`` equals JAX's,
``np.array_equal`` on float64.
"""

import zipfile

import numpy as np
import pytest

from ess_tpu.data import readers as jax_readers

from ess_tpu_torch.data import readers


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


def write_stream(path: str, n: int = 2503, seed: int = 0) -> str:
    """A stream of ``n`` events over ~1 s with bad lines mixed in; ``.zip``
    paths hold it as their only member."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1.0, n))
    lines = ["346 260"]
    for i in range(n):
        lines.append(f"{t[i]:.9f} {rng.integers(0, 346)} "
                     f"{rng.integers(0, 260)} {rng.integers(0, 2)}")
        if i % 97 == 5:
            lines.append(["", "1.0 2 3", "0.5 1 2 1 9", "   "][i % 4])
    text = "\n".join(lines) + "\n"
    if path.endswith(".zip"):
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("events.txt", text)
    else:
        with open(path, "w") as f:
            f.write(text)
    return path


def events_after(path: str, start_index: int) -> int:
    """Events of the stream after the header and ``start_index`` lines."""
    with readers._open_text(path) as f:
        lines = f.read().splitlines()[1 + start_index:]
    return sum(len(line.split()) == 4 for line in lines)


def same_windows(port, ref) -> int:
    got, want = list(port), list(ref)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float64 and a.shape[1] == 4
        assert np.array_equal(a, b)
    return len(got)


@pytest.mark.parametrize("ext", ["txt", "zip"])
def test_header(tmp_path, ext):
    path = write_stream(str(tmp_path / f"ev.{ext}"))
    assert readers.read_header(path) == jax_readers.read_header(path) == (
        346, 260)


@pytest.mark.parametrize("start_index", [0, 37])
@pytest.mark.parametrize("num_events", [500, 1000, 7])
@pytest.mark.parametrize("ext", ["txt", "zip"])
def test_fixed_size_windows_match_jax(tmp_path, ext, num_events, start_index):
    """N events a window; the partial last window is dropped."""
    path = write_stream(str(tmp_path / f"ev.{ext}"))
    n = same_windows(
        readers.FixedSizeEventReader(path, num_events, start_index),
        jax_readers.FixedSizeEventReader(path, num_events, start_index))
    assert n == events_after(path, start_index) // num_events


@pytest.mark.parametrize("start_index", [0, 37])
@pytest.mark.parametrize("duration_ms", [50.0, 33.3, 2000.0])
@pytest.mark.parametrize("ext", ["txt", "zip"])
def test_fixed_duration_windows_match_jax(tmp_path, ext, duration_ms,
                                          start_index):
    """A window closes with (and keeps) the first event past its cutoff;
    the tail is yielded."""
    path = write_stream(str(tmp_path / f"ev.{ext}"))
    same_windows(
        readers.FixedDurationEventReader(path, duration_ms, start_index),
        jax_readers.FixedDurationEventReader(path, duration_ms, start_index))
    windows = list(readers.FixedDurationEventReader(path, duration_ms,
                                                    start_index))
    assert sum(len(w) for w in windows) == events_after(path, start_index)
    stamp = windows[0][0, 0]   # then the event that closed the last window
    for w in windows[:-1]:
        assert w[-1, 0] > stamp + duration_ms / 1000
        assert (w[:-1, 0] <= stamp + duration_ms / 1000).all()
        stamp = w[-1, 0]

