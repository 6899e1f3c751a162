"""The benchmark's frozen generator against the committed fixtures, and
its seeding."""

import os

import numpy as np

from slambench.traffic.generator import fixture_lines, make_log, parse_lines

DATA = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "data")


def _read(name):
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def test_office_fixture_byte_for_byte():
    clf, gt = fixture_lines("office", 500, seed=7)
    assert clf == _read("office_loop.clf")
    assert gt == _read("office_loop.gt")


def test_killian_movers_fixture_byte_for_byte():
    clf, gt = fixture_lines("killian", 800, seed=7, n_movers=3)
    assert clf == _read("killian_movers.clf")
    assert gt == _read("killian_movers.gt")


def test_parse_matches_the_log_reader_convention():
    clf, gt = fixture_lines("office", 20, seed=7)
    lines = [ln for ln in clf.splitlines() if ln.startswith("FLASER")]
    log = parse_lines(lines, gt.splitlines())
    first = lines[3].split()
    r = np.asarray(first[2:182], float)
    assert log.scans[3].shape == (int(((r > 0.05) & (r < 50.0)).sum()), 2)
    assert log.scans[3].dtype == np.float32
    np.testing.assert_allclose(log.odo[3, 2],
                               np.degrees(float(first[184])), rtol=1e-6)


SPEC = dict(name="office", world="office", frames=30, beams=180,
            n_movers=0)


def test_seed_draws_the_noise_not_the_path():
    a = make_log(SPEC, 2**31 + 11, 0)
    b = make_log(SPEC, 2**31 + 11, 0)
    c = make_log(SPEC, 2**31 + 12, 0)
    d = make_log(SPEC, 2**31 + 11, 1)
    assert all(np.array_equal(x, y) for x, y in zip(a.scans, b.scans))
    np.testing.assert_array_equal(a.odo, b.odo)
    np.testing.assert_array_equal(a.gt, c.gt)
    assert not np.array_equal(a.odo[1:], c.odo[1:])
    assert not np.array_equal(a.odo[1:], d.odo[1:])
    assert len(a.scans) == len(c.scans) == 30
