"""A run of each cell at a small size on the CPU, with the harness's look
for a card skipped: the result's shape, the sound run correct, each fault
the cell can have and the control coming out not correct, the check's
numbers on runs of a fixed length as they were before it judged MP2
frames; and on a card, the control at the cell's own size."""

import json
import os

import numpy as np
import pytest

from conftest import FLEET, TUNER, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", [FLEET, TUNER])
def test_sound_run_is_correct_and_the_line_has_the_contracts_keys(tiny, cell):
    line = run_tiny(tiny, cell)
    assert list(line) == KEYS + ["checks"]
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"air_rate", "latency_p90_ms",
                                    "host_cpu_ms_per_air_s", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    json.dumps(line)


def _state_unchanged(monkeypatch):
    from dab_radio_tpu_torch.models.demodulator import OFDMDemodulator
    step = OFDMDemodulator._frame_step_impl

    def frozen(self, carry, window):
        _, out = step(self, carry, window)
        return carry, out
    monkeypatch.setattr(OFDMDemodulator, "_frame_step_impl", frozen)


def _half_left_out(monkeypatch):
    """Half of the batch (the fleet's streams, the tuner's group of
    subchannels) left out of the outputs."""
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    from dab_radio_tpu_torch.models.receiver import DabPlusChannel
    fire = FusedFleet._fire
    monkeypatch.setattr(FusedFleet, "_fire", lambda self, b, ev: fire(
        self, b, ev) if b < self.N // 2 else None)
    handle = DabPlusChannel._handle_payload
    monkeypatch.setattr(DabPlusChannel, "_handle_payload",
                        lambda self, p: handle(self, p)
                        if self.msc.cfg.start_address == 0 else None)


def _answer_altered(monkeypatch):
    from dab_radio_tpu_torch.dab.aac import SuperframeProcessor
    finish = SuperframeProcessor.finish

    def altered(self, corrected, nerr):
        res = finish(self, corrected, nerr)
        if res is not None:
            header, aus = res
            aus = [bytes([aus[0][0] ^ 1]) + aus[0][1:]] + list(aus[1:])
            res = header, aus
        return res
    monkeypatch.setattr(SuperframeProcessor, "finish", altered)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", [FLEET, TUNER])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    """The exchange between chips is no fault here: every cell takes one."""
    FAULTS[fault](monkeypatch)
    line = run_tiny(tiny, cell)
    assert not line["correct"], line["checks"]


def _control_is_correct(keep, device):
    """The verdict that decides a run's `correct`, on the control's
    numbers, which are the same numbers as the program's."""
    import control
    from reference import check
    program = keep["result"]["numbers"]
    numbers = control.control_numbers(keep["traffic"], keep["out"],
                                      keep["cell"], device, program)
    assert set(numbers) == set(program)
    return check.verdict(numbers, keep["cell"]["check"]["limits"]), numbers


def test_a_fleet_read_off_the_frames_is_not_correct(tiny, monkeypatch):
    """The fleet's streams are read on the grid the program aligned them
    to; the reference finds the frames itself, and a grid 40 samples off
    them (which the carry and the bytes alone do not show) is lost sync."""
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    align = FusedFleet.find_alignment
    monkeypatch.setattr(FusedFleet, "find_alignment",
                        lambda self, row: align(self, row) + 80)
    line = run_tiny(tiny, FLEET)
    assert not line["correct"] and line["checks"]["lost_sync"]["value"] > 0


@pytest.mark.parametrize("cell", [FLEET, TUNER])
def test_the_control_is_not_correct(tiny, cell):
    keep = {}
    line = run_tiny(tiny, cell, keep=keep)
    assert line["correct"], line["checks"]
    correct, numbers = _control_is_correct(keep, "cpu")
    assert not correct, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [FLEET, TUNER])
def test_the_control_at_the_cells_size_is_not_correct(cuda_card, cell):
    import run as bench_run
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        keep = {}
        line = bench_run.run_cell(cell, seed, 3.0, False, "cuda", keep=keep)
        assert line["correct"], line["checks"]
        correct, numbers = _control_is_correct(keep, "cuda")
        assert not correct, numbers


@pytest.mark.parametrize("cell", [FLEET, TUNER])
def test_traced_run_reads_the_host_layers_and_puts_the_program_back(
        tiny, cell):
    """On the CPU the device trace is off: the host-clock and span metrics
    are read, the device's are left out, and every wrapped method is the
    program's own again afterwards."""
    from dab_radio_tpu_torch.dab.aac import SuperframeProcessor
    from dab_radio_tpu_torch.models.fused_fleet import FusedFleet
    from dab_radio_tpu_torch.ops.rs import ReedSolomonDecoder
    before = (FusedFleet.__dict__["_consume"],
              SuperframeProcessor.__dict__["finish"],
              ReedSolomonDecoder.__dict__["decode"])
    line = run_tiny(tiny, cell, trace=True)
    assert list(line) == KEYS + ["checks"] and line["correct"]
    want = {FLEET: {"byte_layer.consume_ms_per_air_s",
                    "byte_layer.push_frames_ms_per_air_s",
                    "rs.decode_ms_per_air_s",
                    "superframe.finish_ms_per_air_s",
                    "round.fetch_wait_ms_per_air_s",
                    "rs.device_codewords_pct"},
            TUNER: {"rs.decode_ms_per_air_s", "superframe.finish_ms_per_air_s",
                    "receiver.msc_channels_ms_per_air_s",
                    "receiver.msc_fetch_ms_per_air_s",
                    "receiver.superframes_ms_per_air_s",
                    "demod.fetch_ms_per_air_s",
                    "rs.device_codewords_pct"}}[cell]
    assert set(line["metrics"]) == want
    # a time is spent wherever it is read; the share of codewords whose
    # syndromes ran on the device: all of the fleet's (its CIF batch is
    # handed its device), none of the tuner's
    times = {k: m["value"] for k, m in line["metrics"].items()
             if k.endswith("_ms_per_air_s")}
    assert len(times) == len(want) - 1 and min(times.values()) > 0
    assert line["metrics"]["rs.device_codewords_pct"]["value"] == \
        {FLEET: 100.0, TUNER: 0.0}[cell]
    assert before == (FusedFleet.__dict__["_consume"],
                      SuperframeProcessor.__dict__["finish"],
                      ReedSolomonDecoder.__dict__["decode"])


def test_a_traffic_key_that_nothing_reads_stops_the_run(tiny):
    """A cell that asks for what no code does (here an open loop, which
    neither driver runs) is refused, not run as something else."""
    from harness import spec
    _, bench = tiny
    cell = spec.cell(TUNER, bench)
    cell["traffic"]["loop"] = "open"
    name = TUNER + ".open"
    with open(os.path.join(bench, "workloads", name + ".json"), "w") as f:
        json.dump(cell, f)
    with pytest.raises(ValueError, match="loop"):
        run_tiny(tiny, name)


def _fixed_run(tiny, cell, steps, seed=123456789012):
    """The traffic, the driver's outputs and the window of a run of
    `steps` steps after the warm-up, as run.run_cell drives them, without
    the clock."""
    from harness import spec
    from traffic import generate
    _, bench = tiny
    c = spec.cell(cell, bench)
    config = spec.config(c["config"], bench)
    traffic = generate.make(config["multiplex"], c["traffic"], seed, "cpu")
    driver = spec.driver(config["driver"], bench).Driver(
        config, c, traffic, "cpu", np.random.default_rng([seed, 7]))
    driver.warm_up(**c["warmup"])
    unit0 = driver.last_unit
    driver.in_window = True
    for _ in range(steps):
        driver.step()
    driver.in_window = False
    window = (unit0 + 1, driver.last_unit)
    driver.finish()
    return traffic, driver.outputs(), window, c["check"]


# check.compare on runs of a fixed length, and on the same outputs with
# the first AU of the window's second unit altered, left out, and kept
# twice: (steps, window, AUs kept, attempted, the integer numbers, then
# au_errors with each fault), as the check read them when it judged DAB+
# alone
BEFORE = {
    FLEET: (6, (5, 10), 204, 108, {"au_errors": 0, "db_errors": 0,
                                   "lost_sync": 0}, (2, 1, 1)),
    TUNER: (10, (12, 17), 66, 30, {"au_errors": 0, "db_errors": 0,
                                   "lost_sync": 0, "softbit_gap": 1},
            (2, 1, 1)),
}


@pytest.mark.parametrize("cell", [FLEET, TUNER])
def test_the_checks_numbers_on_dabplus_are_as_before(tiny, cell):
    from reference import check
    steps, window, kept, attempted, numbers, faults = BEFORE[cell]
    traffic, out, got_window, cell_check = _fixed_run(tiny, cell, steps)
    assert got_window == window and len(out["aus"]) == kept
    r = check.compare(traffic, out, window, cell_check, "cpu")
    assert r["attempted"] == attempted and r["failed"] == 0
    assert {k: v for k, v in r["numbers"].items() if k in numbers} == numbers
    aus = out["aus"]
    j = next(k for k, a in enumerate(aus) if a[4] == window[0] + 1)
    b, s, i, au, u = aus[j]
    broken = (aus[:j] + [(b, s, i, bytes([au[0] ^ 1]) + au[1:], u)]
              + aus[j + 1:], aus[:j] + aus[j + 1:], aus + [aus[j]])
    assert tuple(check.compare(traffic, dict(out, aus=a), window, cell_check,
                               "cpu")["numbers"]["au_errors"]
                 for a in broken) == faults
