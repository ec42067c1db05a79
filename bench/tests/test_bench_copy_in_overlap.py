"""The reader ``copy_in_overlap`` on hand-built span lists: the share of
a graph's host ``copy_in`` spans issued while the previous replay still
ran, and nothing where no span carries ``overlapped`` (the eager walk's
spans, or those of a program without the staged copy)."""
import pathlib
import sys
import types

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))


def _read(spans):
    import cell
    return cell.reader("copy_in_overlap")(types.SimpleNamespace(spans=spans))


def _rec(name, dur_s=0.001, **attrs):
    return {"name": name, "trace": 1, "span": 2, "parent": 1, "t0": 0.0,
            "dur_s": dur_s, **attrs}


def _calls(*overlapped):
    """One call's spans for each flag: a host input's copy in, its replay,
    the wait and the copy out, inside ``execute``.  The copy in is staged
    where the flag is 1 or "s" (staged, the replay over by the time its
    copy was issued), direct where it is 0 (the graph's stream idle)."""
    out = []
    for ov in overlapped:
        ci = (_rec("copy_in", overlapped=0) if ov == 0 else
              _rec("copy_in", staged=1, overlapped=int(ov == 1)))
        out += [ci, _rec("replay"), _rec("device_wait"), _rec("copy_out"),
                _rec("execute", bucket="b")]
    return out


@pytest.mark.parametrize("flags, share", [
    ((1, 1, 0, 1), 75.0),
    ((1, 1, 1), 100.0),
    ((1, "s", 1, 0), 50.0),
    # one closed-loop client: each copy finds the stream idle
    ((0, 0, 0, 0, 0), 0.0),
])
def test_the_share_of_overlapped_copies(flags, share):
    assert _read(_calls(*flags)) == pytest.approx(share)


def test_a_direct_copy_in_is_outside_the_share():
    """A device tensor's copy in (no ``overlapped``) and spans of other
    names leave the share of the staged ones as it is."""
    spans = _calls(1, 0) + [_rec("copy_in"), _rec("stack", overlapped=1)]
    assert _read(spans) == pytest.approx(50.0)


@pytest.mark.parametrize("what", ["no window", "no spans", "parent's trace",
                                  "eager walk"])
def test_nothing_to_read(what):
    """The parent's graph path and the eager walk write ``copy_in`` spans
    without the attribute: None, never a raise, and never 0."""
    unstaged = [{k: v for k, v in r.items() if k not in ("staged",
                                                         "overlapped")}
                for r in _calls(1, 0, 1)]
    eager = [_rec("copy_in"), _rec("copy_out"), _rec("guard"),
             _rec("execute")]
    spans = {"no window": None, "no spans": [], "parent's trace": unstaged,
             "eager walk": eager}[what]
    assert _read(spans) is None
