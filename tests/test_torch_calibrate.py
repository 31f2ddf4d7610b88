"""Port parity: ``repro_torch.calibrate`` against ``benchmarks/calibrate.py``.

The fit is held to the reference's at rel <= 1e-6 (the engine's standing
bar against the reference, ROADMAP Queue 3) on every app the reference can
fit.  The reference cannot lower decode_attention's and ssd_scan's kernel
specs (JAX 0.9's ``'jit'`` primitive, ROADMAP Queue 3), so its own
``fit()`` raises; it is run over its other apps, and for those two the
oracle is the reference's fold over the port's segments (the split the fit
divides) with the reference's frozen ``ML_TARGET_NS``.  The committed
profiles must be a fixed point of the port's fit (``max |fit - committed|
< 0.05``, the reference's own check), and ``--scorecard`` exits 0 with the
reference's anchor lines.
"""
import os
import sys

import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import calibrate as ref_cal  # noqa: E402
from repro.core import frontend as ref_fe  # noqa: E402
from repro.core import scalar_pipeline as ref_sp  # noqa: E402
from repro_torch import calibrate as cal  # noqa: E402
from repro_torch.core import scalar_pipeline as sp  # noqa: E402
from repro_torch.core import tracegen  # noqa: E402

JIT_APPS = ("decode_attention", "ssd_scan")
CAVEAT = ("the reference cannot lower this app's kernel spec (JAX 0.9's "
          "'jit' primitive, ROADMAP Queue 3): its fold over the port's "
          "segments is the oracle")


@pytest.fixture(scope="module")
def port_fit():
    return cal.fit(device="cpu")


@pytest.fixture(scope="module")
def ref_fit():
    """The reference's ``fit()`` over every app whose targets it can
    compute without lowering decode_attention or ssd_scan."""
    targets = ref_cal._anchor_targets
    try:
        ref_cal._anchor_targets = lambda: {
            a: t for a, t in targets().items() if a not in JIT_APPS}
        return ref_cal.fit()
    finally:
        ref_cal._anchor_targets = targets


def test_reference_fails_only_on_the_caveat_apps():
    for app in JIT_APPS:
        with pytest.raises(ref_fe.FrontendError, match="'jit'"):
            ref_cal._cycles_split(app)
    assert set(cal.ML_TARGET_NS) == set(ref_cal.ML_TARGET_NS)
    assert cal.ML_TARGET_NS == ref_cal.ML_TARGET_NS
    assert (cal.PF_MEM_STALL, cal.PF_LT_MARGIN) == (ref_cal.PF_MEM_STALL,
                                                    ref_cal.PF_LT_MARGIN)


@pytest.mark.parametrize("app", sorted(set(tracegen.APPS) - set(JIT_APPS)))
def test_fit_matches_reference(port_fit, ref_fit, app):
    for got, want in zip(port_fit[app], ref_fit[app]):
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30), (app, got,
                                                                 want)


@pytest.mark.parametrize("app", sorted(set(tracegen.APPS)))
def test_cycles_split_matches_reference_fold(app):
    """The split the fit divides: the reference's own where it can lower
    the app, else the reference's fold over the port's segments; rel 1e-6
    (XLA's fused multiply-adds, ROADMAP Queue 3)."""
    got = cal._cycles_split(app)
    if app in JIT_APPS:
        seg0 = sp.segments_for(app).copy()
        seg0[4, 5] = 0.0
        cyc0, _ = ref_sp._pipeline_jit(
            jnp.asarray(seg0),
            tuple(jnp.asarray(p) for p in ref_sp.cfg_scalar_params(None)))
        want = (float(cyc0), float(sp.segments_for(app)[4, 0]),
                tracegen.scalar_profile_for(app).roi_instr_fraction)
    else:
        want = ref_cal._cycles_split(app)
    # XLA contracts some a + b * c of the jitted fold into one FMA: the
    # standing rel 1e-6 bar between the port and the reference
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-6 * abs(w), (app, got, want,
                                             CAVEAT if app in JIT_APPS else "")


def test_fit_is_a_fixed_point_of_the_committed_profiles(port_fit, capsys):
    assert set(port_fit) == set(tracegen.APPS)
    assert cal.drift(port_fit) < 0.05
    assert cal.print_fit(port_fit) < 0.05
    out = capsys.readouterr().out
    assert "fixed point: committed values reproduce the fit" in out


def test_scorecard_exits_zero_with_the_reference_anchor_lines(capsys):
    """``--scorecard`` exits 0; its anchor section is the reference's line
    for line (the reference prints it before its event breakdown reaches
    decode_attention and raises)."""
    assert cal.main(["--scorecard", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    with pytest.raises(ref_fe.FrontendError, match="'jit'"):
        ref_cal.scorecard()
    want = capsys.readouterr().out.splitlines()
    head = want.index("== per-app event breakdown (cycles per ROI "
                      "instruction) ==")
    assert got[:head] == want[:head]
    assert len([ln for ln in got[:head] if "] ok" in ln]) == 11
    # the event lines the reference printed before it raised
    printed = want[head:]
    assert printed and got[head:head + len(printed)] == printed
    assert "scorecard wall-clock" in got[-1]
