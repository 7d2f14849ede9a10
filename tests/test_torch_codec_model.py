"""The port's codec cost model (``codec.model``), rate controller
(``codec.rate``) and topology copy against the JAX reference.

These modules are pure Python in the reference and copies in the port,
so they are held to equality: the same numbers from every pricing
method, the same decision and the same operating point at every frame
of a scripted run, and the same density calibration.  The calibration
renders a sequence in each package (the port on the CPU here) and fits
a line to the measured tile densities: the densities must be equal,
and (gain, floor) within 1e-9 relative (both fits are numpy's lstsq on
the same float64 inputs, so they agree to the bit in practice).
"""

import dataclasses
import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.codec as jcodec
from repro.codec import model as jmodel
from repro.codec import rate as jrate
from repro.codec import ref as jcr
from repro.core import topology as jtopo
from repro.data import rgbd as jrgbd
from repro.sim import hardware
import repro_torch.codec as tcodec
from repro_torch.codec import model as tmodel
from repro_torch.codec import rate as trate
from repro_torch.codec import wire as twire
from repro_torch.core import topology as ttopo
from repro_torch.data import rgbd as trgbd


def _asdict(model):
    return None if model is None else dataclasses.asdict(model)


def test_topology_is_a_verbatim_copy():
    assert inspect.getsource(ttopo) == inspect.getsource(jtopo)
    tier = ttopo.Tier(**dataclasses.asdict(hardware.EDGE_GPU))
    assert dataclasses.asdict(tier) == dataclasses.asdict(hardware.EDGE_GPU)


def test_codec_exports_the_reference_names():
    names = {"BITS_RAW", "CodecModel", "IDENTITY", "CodecConfig", "RateController",
             "calibrate_density_map", "identity_config", "motion_profile",
             "sequence_motion"}
    assert names <= set(dir(jcodec)) and names <= set(dir(tcodec))
    assert tcodec.BITS_RAW == jcodec.BITS_RAW == 32
    assert _asdict(tcodec.IDENTITY) == _asdict(jcodec.IDENTITY)
    assert (trate.DEFAULT_DENSITY_GAIN, trate.DEFAULT_DENSITY_FLOOR) == (
        jrate.DEFAULT_DENSITY_GAIN, jrate.DEFAULT_DENSITY_FLOOR)
    assert (tmodel.ENCODE_OPS_PER_BYTE, tmodel.DECODE_OPS_PER_BYTE) == (
        jmodel.ENCODE_OPS_PER_BYTE, jmodel.DECODE_OPS_PER_BYTE)


POINTS = [
    dict(name="raw"),
    dict(name="dq", quant_bits=8, keyframe_interval=8, change_density=0.2,
         header_nbytes=64, encode_flops_per_byte=3.0, decode_flops_per_byte=19.0),
    dict(name="dq16", quant_bits=16, keyframe_interval=4, change_density=0.4,
         header_nbytes=64, min_payload_nbytes=0, encode_flops_per_byte=2.5),
    dict(name="v2", quant_bits=8, keyframe_interval=15, change_density=0.1,
         header_nbytes=64, encode_flops_per_byte=3.0, decode_flops_per_byte=1.5,
         entropy_coding=True, entropy_ratio=0.55, entropy_flops_per_byte=12.0),
    dict(name="one_bit", quant_bits=1, keyframe_interval=1, change_density=1.0),
]
TIERS = [hardware.THIN_CLIENT_NO_GPU, hardware.EDGE_GPU, hardware.PHONE_NPU,
         hardware.LAPTOP_IGPU]


@pytest.mark.parametrize("point", POINTS, ids=[p["name"] for p in POINTS])
def test_codec_model_prices_as_the_reference(point):
    """Every ratio, byte count and time of one operating point, on the
    reference's tiers, equal to the reference's."""
    ref_m, port_m = jmodel.CodecModel(**point), tmodel.CodecModel(**point)
    assert _asdict(port_m) == _asdict(ref_m)
    for prop in ("keyframe_ratio", "delta_ratio", "ratio"):
        assert getattr(port_m, prop) == getattr(ref_m, prop), prop
    for n in (0, 108, 4096, 65_536, 537_600):
        for fn in ("applies", "wire_nbytes", "state_applies", "state_wire_nbytes"):
            assert getattr(port_m, fn)(n) == getattr(ref_m, fn)(n), (fn, n)
        for ref_tier in TIERS:
            tier = ttopo.Tier(**dataclasses.asdict(ref_tier))
            assert tmodel.tier_codec_rate(tier) == jmodel.tier_codec_rate(ref_tier)
            for fn in ("encode_time", "decode_time", "state_encode_time",
                       "state_decode_time"):
                assert getattr(port_m, fn)(n, tier) == getattr(ref_m, fn)(n, ref_tier)


def test_codec_model_calibration_and_validation_match_the_reference():
    kw = dict(quant_bits=8, keyframe_interval=8, change_density=0.25,
              encode_flops=1.2e11, encode_mem_bandwidth=2.5e10,
              decode_flops=4.0e13, decode_mem_bandwidth=9.0e11)
    assert _asdict(tmodel.CodecModel.from_roofline("cal", **kw)) == _asdict(
        jmodel.CodecModel.from_roofline("cal", **kw))
    bad = [dict(quant_bits=0), dict(quant_bits=33), dict(keyframe_interval=0),
           dict(change_density=1.5), dict(header_nbytes=-1),
           dict(encode_flops_per_byte=-1.0), dict(entropy_ratio=0.0),
           dict(entropy_flops_per_byte=-1.0)]
    for kwargs in bad:
        for mod in (jmodel, tmodel):
            with pytest.raises(ValueError):
                mod.CodecModel(name="bad", **kwargs)


def test_codec_config_validation_matches_the_reference():
    base = dict(name="dq", quant_bits=8, keyframe_interval=8, change_density=0.2)
    bad = [dict(bits_ladder=()), dict(bits_ladder=(16, 3)),
           dict(density_cuts=(0.1, 0.2, 0.3)), dict(density_bins=()),
           dict(density_bins=(0.05, 0.1)), dict(pressure_alpha=0.0),
           dict(pressure_threshold=0.0), dict(min_dwell_frames=-1),
           dict(cell_threshold=0.0), dict(cell_alpha=0.0), dict(cell_stagger=-1.0),
           dict(resync_bound=-1), dict(drop_alpha=0.0), dict(drop_threshold=0.0)]
    for kwargs in bad:
        for mod, mmod in ((jrate, jmodel), (trate, tmodel)):
            with pytest.raises(ValueError):
                mod.CodecConfig(base=mmod.CodecModel(**base), **kwargs)
    port, ref_cfg = trate.identity_config(), jrate.identity_config()
    assert not port.adapt and _asdict(port.base) == _asdict(ref_cfg.base)


# A scripted run: the same link pressure, shared-cell waits, dropped
# frames and scene motion through both packages' controllers.
LEGS = (SimpleNamespace(link="uplink", latency=0.012),
        SimpleNamespace(link="downlink", latency=0.004))
PLAN = SimpleNamespace(legs=LEGS)
PRESSURE = [1.0] * 30 + [2.2] * 40 + [1.0] * 40 + [1.6] * 25 + [1.0] * 25 + [3.0] * 20
CELL_WAIT = [0.0] * 50 + [0.004] * 60 + [0.0] * 30 + [0.01] * 40 + [0.0] * 20
DROPPED = {60, 61, 62, 90, 91, 92, 93, 150}

CONTROLLERS = {
    "pressure_and_motion": dict(min_dwell_frames=4),
    "cell_and_resync": dict(min_dwell_frames=2, cell_threshold=0.002, cell_stagger=0.5,
                            resync_bound=3, bits_ladder=(32, 16, 8, 4)),
    "fixed": dict(adapt=False),
    "no_dwell_fast_motion": dict(min_dwell_frames=0, density_gain=6.0,
                                 density_floor=0.05),
}


@pytest.mark.parametrize("name", list(CONTROLLERS))
def test_rate_controller_decides_as_the_reference(name):
    motion = tuple(float(m) for m in jrate.sequence_motion(
        jrgbd.SequenceConfig(num_frames=90)))
    assert trate.sequence_motion(trgbd.SequenceConfig(num_frames=90)) == motion
    base = dict(name="dq", quant_bits=8, keyframe_interval=8, change_density=0.2,
                header_nbytes=64, encode_flops_per_byte=3.0,
                decode_flops_per_byte=19.0)
    kw = dict(CONTROLLERS[name], motion=motion)
    ref_rc = jrate.RateController(jrate.CodecConfig(base=jmodel.CodecModel(**base), **kw),
                                  client_id=1)
    port_rc = trate.RateController(trate.CodecConfig(base=tmodel.CodecModel(**base), **kw),
                                   client_id=1)
    assert _asdict(port_rc.model) == _asdict(ref_rc.model)
    decisions = 0
    for i in range(len(PRESSURE)):
        if i in DROPPED:
            continue
        observed = tuple((leg.link, leg.latency * PRESSURE[i]) for leg in LEGS)
        want = ref_rc.observe(i, observed, PLAN, cell_wait=CELL_WAIT[i])
        got = port_rc.observe(i, observed, PLAN, cell_wait=CELL_WAIT[i])
        assert _asdict(got) == _asdict(want), i
        assert _asdict(port_rc.model) == _asdict(ref_rc.model), i
        decisions += want is not None
    assert port_rc.transitions == ref_rc.transitions
    assert port_rc.switches == ref_rc.switches == decisions
    if name != "fixed":
        assert decisions > 0  # the script does move the operating point


def test_motion_profile_matches_the_reference():
    truth = jrgbd.truth_trajectory(jrgbd.SequenceConfig(num_frames=20))
    assert trate.motion_profile(truth) == jrate.motion_profile(truth)
    assert trate.motion_profile(torch.from_numpy(np.array(truth))) == (
        jrate.motion_profile(truth))


def test_density_calibration_matches_the_reference():
    """SequenceConfig(num_frames=30, noise_std=0.0) at the calibration's
    own tile (8x32) and threshold 0: equal densities per transition, and
    (gain, floor) within 1e-9 relative."""
    ref_cfg = jrgbd.SequenceConfig(num_frames=30, noise_std=0.0)
    port_cfg = trgbd.SequenceConfig(num_frames=30, noise_std=0.0)
    j_frames, _ = jrgbd.render_sequence(ref_cfg)
    t_frames, _ = trgbd.render_sequence(port_cfg, device="cpu")
    kw = dict(threshold=0.0, block_h=8, block_w=32)
    want = np.asarray(jcr.change_density(j_frames, **kw))
    got = twire.change_density(t_frames, **kw)
    assert got.shape == (29,) and np.array_equal(got.numpy(), want)
    assert 0.0 < want.min() and want.max() < 1.0  # a real signal, not saturated

    j_gain, j_floor = jrate.calibrate_density_map(ref_cfg)
    t_gain, t_floor = trate.calibrate_density_map(port_cfg, device="cpu")
    assert t_gain == pytest.approx(j_gain, rel=1e-9, abs=0.0)
    assert t_floor == pytest.approx(j_floor, rel=1e-9, abs=0.0)
    assert t_gain > 0.0 and 0.0 < t_floor < 1.0


def test_density_calibration_reproduces_the_module_defaults():
    """The default configuration (60 frames, noise 0, tile 8x32) on the
    port's CPU path against the reference's: the fit the defaults 4.0 /
    0.145 are rounded from."""
    j_gain, j_floor = jrate.calibrate_density_map()
    t_gain, t_floor = trate.calibrate_density_map(device="cpu")
    assert t_gain == pytest.approx(j_gain, rel=1e-9, abs=0.0)
    assert t_floor == pytest.approx(j_floor, rel=1e-9, abs=0.0)
    assert round(t_gain, 1) == trate.DEFAULT_DENSITY_GAIN
    assert round(t_floor, 3) == trate.DEFAULT_DENSITY_FLOOR


def test_calibration_runs_on_the_card_by_default():
    sig = inspect.signature(trate.calibrate_density_map)
    assert sig.parameters["device"].default == "cuda"
    with pytest.raises(ValueError):
        twire.change_density(torch.zeros((1, 8, 32)))
