"""crfr_torch.utils.debug and utils.profiling on the CPU (crfr/utils/debug.py,
crfr/utils/profiling.py): ``debug_mode`` raises on a NaN or an Inf out of
an op, forward or backward, naming the op, and restores every setting it
changed, on exit and on error; ``no_host_transfers`` does nothing without
a card; ``trace`` writes a Chrome trace holding an ``annotate`` span;
``timed`` returns a positive time and the last result."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import json

import pytest
import torch
import torch._dynamo
from torch.utils._python_dispatch import _get_current_dispatch_mode

from crfr_torch.utils import profiling
from crfr_torch.utils.debug import debug_mode, no_host_transfers


def _settings():
    from torch._logging import _internal

    st = _internal._get_log_state()
    return (torch.is_anomaly_enabled(), _get_current_dispatch_mode(),
            torch._dynamo.config.disable, dict(st.log_qname_to_level), set(st.artifact_names))


def test_nans_raise_naming_the_op_forward_and_backward():
    before = _settings()
    with pytest.raises(FloatingPointError, match="NaN in the output of aten.log"):
        with debug_mode(nans=True):
            torch.log(torch.tensor([1.0, -1.0]))
    assert _settings() == before
    x = torch.zeros(3, requires_grad=True)
    y = (torch.sqrt(x) * 0.0).sum()          # finite forward; 0 · 1/(2·√0) = NaN backward
    with pytest.raises(FloatingPointError, match="NaN in the output of aten"):
        with debug_mode(nans=True):
            y.backward()
    assert _settings() == before
    with debug_mode(nans=True):              # finite work passes, infs are allowed
        assert torch.isinf(torch.tensor([1.0]) / 0).all()
        assert torch.is_anomaly_enabled()
    assert _settings() == before


def test_infs_raise_only_when_asked():
    before = _settings()
    with pytest.raises(FloatingPointError, match="Inf in the output of aten.div"):
        with debug_mode(nans=False, infs=True):
            torch.tensor([1.0]) / 0
    assert _settings() == before
    with debug_mode(nans=False, infs=True):  # a NaN passes when only infs are checked
        assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
        assert not torch.is_anomaly_enabled()
    assert _settings() == before


def test_compile_switches_are_restored_on_error():
    before = _settings()
    with pytest.raises(KeyError):
        with debug_mode(nans=False, disable_jit=True, log_compiles=True):
            assert torch._dynamo.config.disable
            from torch._logging import _internal

            assert "recompiles" in _internal._get_log_state().artifact_names
            raise KeyError("an error inside")
    assert _settings() == before


def test_no_host_transfers_is_inert_without_a_card():
    with no_host_transfers():
        assert torch.ones(3).sum().item() == 3.0
        assert torch.ones(2).cpu().tolist() == [1.0, 1.0]


def test_trace_annotate_and_timed(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("crfr_span"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert prof.trace_path.startswith(str(tmp_path / "tr"))
    assert any(e.get("name") == "crfr_span" for e in events)
    assert any("mm" in str(e.get("name")) for e in events)
    calls = []

    def fn(a):
        calls.append(a)
        return {"y": torch.full((2,), float(a))}

    sec, out = profiling.timed(fn, 3, iters=4, warmup=1)
    assert sec > 0 and torch.equal(out["y"], torch.full((2,), 3.0)) and len(calls) == 5
