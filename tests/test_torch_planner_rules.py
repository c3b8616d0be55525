"""The planner's four rules and the executor's core rule of the JAX package
on the port, held against
the card's measurements and the JAX package.

tools/torch_planner_rules.py timed each rule's candidate path against the
path it would replace on the card (NVIDIA H100 80GB HBM3, 700.00 W;
PLANNER_RULES_GPU.md) at sampled and held-out sizes; the tables below are
that run's (n, sampled or held out, the paths' recipes, the faster way by
more than the spread of the turns: "new" the candidate, "old" the current
path).
  R1  the prime rule (planner.prime_rule_inner): on, the Bluestein on a
      fast core form faster at every prime timed;
  R2  the hole band (executor.hole_band_inner, config.bconv_misaligned):
      off, the Bluestein slower than large_pad at 16 of 21 sizes;
  R3  the dense band (config.dense_fallback_max_n): off, dense_fft slower
      at all 69 sizes;
  R4  the composite rule (FftPlannerGpu._composite_way): on, a composite's
      whole-n Bluestein on K14's four stages gives way to the Bluestein on
      a fast core form or to the split, the cheaper by split_costs.py's
      tables (the card's cost sweep: each core's ns a transform, the CT
      glue's ps an element by p); the way taken the faster, or level, at
      all 40 sampled sizes and all 10 of the first held-out draw, which
      the tables were fitted after, and at the second draw's as
      R4_MISSES says;
  R5  the core rule above 2^20 (executor.core_form, no field): the
      Bluesteins on 2^22 run the glued form (its inner on large2f) in
      place of K14's four stages, 2.41-2.51x faster at all 10 primes
      timed; the Raders on n - 1 in (2^20, 2^22] keep the four stages and
      the Bluesteins on 3*2^20 and 3*2^21 K15's tile form, each faster
      than the glued form at all 10 of its class.
Each decision is checked as recipes and routes, the hole band's inner
against the JAX planner's _radix_conv_inner, the outputs against the JAX
planner and the float64 oracle, and the recipes with the kernels off and
for complex128 against the JAX package's with Pallas off.
"""
import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu import config as ref_config
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.planner import FftPlannerTpu
from rustfft_tpu_torch import FftPlanner, config, executor, recipes, route, split_costs
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.math_utils import PrimeFactors
from rustfft_tpu_torch.planner import FAST_FORMS, FftPlannerGpu, routed_bluestein_inner
from rustfft_tpu_torch.twiddles import host_dft

C64 = np.complex64
TOL = 1e-5

#: R1: (n, set, kind of the replaced recipe ("r" Raders, "b" Bluesteins), its
#: inner length, the candidate Bluestein's inner length, the faster way)
R1_TABLE = (
    (15121, "fit", "r", 15120, 32768, "new"), (24697, "fit", "r", 24696, 65536, "new"),
    (40961, "fit", "r", 40960, 131072, "new"), (58321, "fit", "r", 58320, 131072, "new"),
    (96769, "fit", "r", 96768, 262144, "new"), (163841, "fit", "r", 163840, 393216, "new"),
    (530713, "fit", "r", 530712, 1572864, "new"), (541927, "fit", "r", 541926, 1572864, "new"),
    (555391, "fit", "r", 555390, 1572864, "new"), (566441, "fit", "r", 566440, 1572864, "new"),
    (576577, "fit", "r", 576576, 1572864, "new"), (598501, "fit", "r", 598500, 1572864, "new"),
    (614657, "fit", "r", 614656, 1572864, "new"), (624037, "fit", "r", 624036, 1572864, "new"),
    (637001, "fit", "r", 637000, 1572864, "new"), (653563, "fit", "r", 653562, 1572864, "new"),
    (666541, "fit", "r", 666540, 1572864, "new"), (678133, "fit", "r", 678132, 1572864, "new"),
    (693601, "fit", "r", 693600, 1572864, "new"), (711829, "fit", "r", 711828, 1572864, "new"),
    (725789, "fit", "r", 725788, 1572864, "new"), (735001, "fit", "r", 735000, 1572864, "new"),
    (746981, "fit", "r", 746980, 1572864, "new"), (760321, "fit", "r", 760320, 1572864, "new"),
    (779761, "fit", "r", 779760, 1572864, "new"), (796951, "fit", "r", 796950, 2097152, "new"),
    (816341, "fit", "r", 816340, 2097152, "new"), (828101, "fit", "r", 828100, 2097152, "new"),
    (852151, "fit", "r", 852150, 2097152, "new"), (867001, "fit", "r", 867000, 2097152, "new"),
    (888721, "fit", "r", 888720, 2097152, "new"), (902501, "fit", "r", 902500, 2097152, "new"),
    (921601, "fit", "r", 921600, 2097152, "new"), (940801, "fit", "r", 940800, 2097152, "new"),
    (959617, "fit", "r", 959616, 2097152, "new"), (977593, "fit", "r", 977592, 2097152, "new"),
    (996361, "fit", "r", 996360, 2097152, "new"), (1014301, "fit", "r", 1014300, 2097152, "new"),
    (1029953, "fit", "r", 1029952, 2097152, "new"),
    (1046179, "fit", "r", 1046178, 2097152, "new"), (203353, "fit", "b", 419904, 442368, "new"),
    (152393, "fit", "b", 314928, 393216, "new"), (135589, "fit", "b", 279936, 393216, "new"),
    (114371, "fit", "b", 236196, 262144, "new"), (101603, "fit", "b", 209952, 262144, "new"),
    (121309, "fit", "b", 248832, 262144, "new"), (44017, "fit", "b", 93312, 131072, "new"),
    (85711, "fit", "b", 177147, 262144, "new"), (76213, "fit", "b", 157464, 262144, "new"),
    (90931, "fit", "b", 186624, 262144, "new"), (67619, "fit", "b", 139968, 262144, "new"),
    (80833, "fit", "b", 165888, 262144, "new"), (57119, "fit", "b", 118098, 131072, "new"),
    (50833, "fit", "b", 104976, 131072, "new"), (60631, "fit", "b", 124416, 131072, "new"),
    (22037, "fit", "b", 46656, 65536, "new"), (38153, "fit", "b", 78732, 131072, "new"),
    (33827, "fit", "b", 69984, 131072, "new"), (40433, "fit", "b", 82944, 131072, "new"),
    (28579, "fit", "b", 59049, 65536, "new"), (14723, "fit", "b", 31104, 32768, "new"),
    (25447, "fit", "b", 52488, 65536, "new"), (30319, "fit", "b", 62208, 65536, "new"),
    (26893, "fit", "b", 55296, 65536, "new"), (746497, "fit", "r", 746496, 1572864, "new"),
    (196613, "fit", "b", 419904, 442368, "new"), (88589, "fit", "b", 186624, 262144, "new"),
    (43201, "held", "r", 43200, 131072, "new"), (536407, "held", "r", 536406, 1572864, "new"),
    (595057, "held", "r", 595056, 1572864, "new"), (656371, "held", "r", 656370, 1572864, "new"),
    (719951, "held", "r", 719950, 1572864, "new"), (775711, "held", "r", 775710, 1572864, "new"),
    (857737, "held", "r", 857736, 2097152, "new"), (929501, "held", "r", 929500, 2097152, "new"),
    (1008421, "held", "r", 1008420, 2097152, "new"), (11003, "held", "b", 23328, 32768, "new"),
    (19121, "held", "b", 39366, 65536, "new"), (16979, "held", "b", 34992, 65536, "new"),
    (20173, "held", "b", 41472, 65536, "new"), (12697, "held", "b", 26244, 32768, "new"),
    (9521, "held", "b", 19683, 32768, "new"), (13477, "held", "b", 27648, 32768, "new"),
    (11969, "held", "b", 24576, 32768, "new"), (8501, "held", "b", 17496, 32768, "new"),
    (10133, "held", "b", 20736, 32768, "new"),
)

#: R2: (n, set, the hole band's inner length, the faster way)
R2_TABLE = (
    (15625, "fit", 32768, "old"), (19683, "fit", 65536, "old"), (59049, "fit", 131072, "old"),
    (16383, "fit", 32768, "new"), (9369, "fit", 32768, "tie"), (32767, "fit", 65536, "new"),
    (18725, "fit", 65536, "old"), (65535, "fit", 131072, "new"), (37453, "fit", 131072, "old"),
    (131061, "fit", 262144, "old"), (74905, "fit", 262144, "old"), (19505, "held", 65536, "old"),
    (28251, "held", 65536, "new"), (42517, "held", 131072, "old"), (52773, "held", 131072, "old"),
    (63535, "held", 131072, "new"), (84623, "held", 262144, "old"),
    (97075, "held", 262144, "old"), (110199, "held", 262144, "old"),
    (123927, "held", 262144, "old"), (131047, "held", 262144, "old"),
)

#: R3: (n, set, kind of the planner's recipe, its inner length, the faster
#: way); dense_fft is the candidate
R3_TABLE = (
    (257, "fit", "r", 256, "old"), (514, "fit", "b", 1152, "old"),
    (1031, "fit", "b", 2304, "old"), (2042, "fit", "b", 4096, "old"),
    (307, "fit", "b", 648, "old"), (353, "fit", "b", 729, "old"), (401, "fit", "r", 400, "old"),
    (449, "fit", "r", 448, "old"), (499, "fit", "b", 1024, "old"), (541, "fit", "r", 540, "old"),
    (569, "fit", "b", 1152, "old"), (607, "fit", "b", 1296, "old"),
    (634, "fit", "b", 1296, "old"), (673, "fit", "r", 672, "old"), (706, "fit", "b", 1536, "old"),
    (743, "fit", "b", 1536, "old"), (771, "fit", "b", 1728, "old"),
    (807, "fit", "b", 1728, "old"), (829, "fit", "b", 1728, "old"),
    (857, "fit", "b", 1728, "old"), (881, "fit", "b", 2048, "old"),
    (919, "fit", "b", 2048, "old"), (939, "fit", "b", 2048, "old"),
    (974, "fit", "b", 2048, "old"), (1006, "fit", "b", 2048, "old"),
    (1033, "fit", "b", 2304, "old"), (1059, "fit", "b", 2304, "old"),
    (1093, "fit", "b", 2304, "old"), (1119, "fit", "b", 2304, "old"),
    (1151, "fit", "b", 2304, "old"), (1186, "fit", "b", 3072, "old"),
    (1213, "fit", "b", 3072, "old"), (1234, "fit", "b", 3072, "old"),
    (1277, "fit", "b", 3072, "old"), (1294, "fit", "b", 3072, "old"),
    (1318, "fit", "b", 3072, "old"), (1354, "fit", "b", 3072, "old"),
    (1383, "fit", "b", 3072, "old"), (1427, "fit", "b", 3072, "old"),
    (1453, "fit", "b", 3072, "old"), (1481, "fit", "b", 3072, "old"),
    (1502, "fit", "b", 3072, "old"), (1538, "fit", "b", 4096, "old"),
    (1569, "fit", "b", 4096, "old"), (1607, "fit", "b", 4096, "old"),
    (1627, "fit", "b", 4096, "old"), (1663, "fit", "b", 4096, "old"),
    (1699, "fit", "b", 4096, "old"), (1723, "fit", "b", 4096, "old"),
    (1759, "fit", "b", 4096, "old"), (1787, "fit", "b", 4096, "old"),
    (1822, "fit", "b", 4096, "old"), (1858, "fit", "b", 4096, "old"),
    (1882, "fit", "b", 4096, "old"), (1923, "fit", "b", 4096, "old"),
    (1951, "fit", "b", 4096, "old"), (1983, "fit", "b", 4096, "old"),
    (2017, "fit", "b", 4096, "old"), (2039, "fit", "b", 4096, "old"),
    (409, "held", "b", 864, "old"), (647, "held", "b", 1296, "old"),
    (839, "held", "b", 1728, "old"), (1018, "held", "b", 2048, "old"),
    (1201, "held", "b", 3072, "old"), (1373, "held", "b", 3072, "old"),
    (1563, "held", "b", 4096, "old"), (1753, "held", "b", 4096, "old"),
    (1949, "held", "b", 4096, "old"), (2038, "held", "b", 4096, "old"),
)

#: R4: (n, set, the replaced Bluestein's inner length (K14's four stages),
#: the way the composite rule takes ("b" the Bluestein on the fast form's
#: inner, given; "s" the split, its p), the way the card measured faster by
#: more than the spread of the turns ("b", "s", or "b=s" level))
R4_TABLE = (
    (8482, "fit", 17496, "b", 32768, "b"), (8984, "fit", 18432, "s", 8, "s"), (9532, "fit", 19683, "b", 32768, "b=s"),
    (10096, "fit", 20736, "s", 16, "s"), (11014, "fit", 23328, "b", 32768, "b"), (11980, "fit", 24576, "b", 32768, "b"),
    (12722, "fit", 26244, "b", 32768, "b"), (13476, "fit", 27648, "b", 32768, "b"), (14676, "fit", 31104, "b", 32768, "b"),
    (16939, "fit", 34992, "s", 13, "s"), (19048, "fit", 39366, "b", 65536, "b"), (20225, "fit", 41472, "s", 25, "s"),
    (22045, "fit", 46656, "b", 65536, "b"), (25405, "fit", 52488, "b", 65536, "b"), (26971, "fit", 55296, "b", 65536, "b"),
    (28590, "fit", 59049, "s", 30, "s"), (30311, "fit", 62208, "b", 65536, "b"), (33898, "fit", 69984, "s", 34, "s"),
    (38111, "fit", 78732, "s", 23, "s"), (40412, "fit", 82944, "b", 131072, "b"), (44083, "fit", 93312, "b", 131072, "b=s"),
    (50822, "fit", 104976, "b", 131072, "b"), (57192, "fit", 118098, "b", 131072, "b=s"), (60627, "fit", 124416, "b", 131072, "b=s"),
    (67793, "fit", 139968, "s", 11, "s"), (76234, "fit", 157464, "s", 94, "s"), (80844, "fit", 165888, "s", 12, "s"),
    (85777, "fit", 177147, "s", 31, "s"), (90955, "fit", 186624, "b", 262144, "b"), (101648, "fit", 209952, "b", 262144, "b"),
    (114348, "fit", 236196, "b", 262144, "b"), (121254, "fit", 248832, "s", 42, "s"), (135521, "fit", 279936, "s", 53, "s"),
    (152487, "fit", 314928, "b", 393216, "b"), (203272, "fit", 419904, "b", 442368, "b"), (8199, "fit", 17496, "s", 9, "s"),
    (41484, "fit", 93312, "s", 12, "s"), (98324, "fit", 209952, "b", 262144, "b"), (131084, "fit", 279936, "b", 393216, "b"),
    (196611, "fit", 419904, "b", 442368, "b"), (148543, "held", 314928, "b", 393216, "b"), (33828, "held", 69984, "s", 12, "s"),
    (58931, "held", 118098, "s", 31, "s"), (49365, "held", 104976, "s", 45, "s"), (86883, "held", 177147, "b", 262144, "b"),
    (103287, "held", 209952, "b", 262144, "b"), (150408, "held", 314928, "b", 393216, "b"), (117715, "held", 236196, "s", 65, "s"),
    (205853, "held", 419904, "b", 442368, "b"), (121177, "held", 248832, "b", 262144, "b=s"),
    (38275, "held2", 78732, "s", 25, "s"), (20110, "held2", 41472, "s", 10, "s"), (76520, "held2", 157464, "s", 40, "s"),
    (56820, "held2", 118098, "s", 60, "s"), (65674, "held2", 139968, "s", 14, "s"), (39739, "held2", 82944, "s", 49, "s"),
    (132149, "held2", 279936, "s", 103, "s"), (46140, "held2", 93312, "s", 60, "s"), (76455, "held2", 157464, "s", 45, "s"),
    (74395, "held2", 157464, "s", 5, "s"), (205509, "held2", 419904, "b", 442368, "b"), (117605, "held2", 236196, "b", 262144, "b"),
    (27137, "held2", 55296, "b", 65536, "b"), (29069, "held2", 59049, "b", 65536, "b"), (26653, "held2", 55296, "b", 65536, "b"),
    (151675, "held2", 314928, "b", 393216, "b"), (87355, "held2", 177147, "b", 262144, "b"), (156345, "held2", 314928, "b", 393216, "b"),
    (8258, "held2", 17496, "b", 32768, "b"), (119348, "held2", 248832, "b", 262144, "b"),
    (87545, "fit3", 177147, "s", 5, "b=s"), (87595, "fit3", 177147, "s", 5, "b=s"),
    (87695, "fit3", 177147, "s", 5, "b=s"), (87755, "fit3", 177147, "s", 5, "b=s"),
    (116665, "fit3", 236196, "b", 262144, "b"), (122855, "fit3", 248832, "b", 262144, "b"),
    (139863, "held3", 279936, "s", 69, "s"), (12521, "held3", 26244, "s", 19, "s"),
    (137615, "held3", 279936, "s", 85, "s"), (67659, "held3", 139968, "s", 57, "s"),
    (136441, "held3", 279936, "s", 47, "s"), (39944, "held3", 82944, "b", 131072, "b"),
    (198674, "held3", 419904, "b", 442368, "b"), (197334, "held3", 419904, "b", 442368, "b"),
    (151136, "held3", 314928, "b", 393216, "b"), (88514, "held3", 177147, "b", 262144, "b"),
)

#: R4's sizes where the rule does not take a way the card measured fastest
#: ("held2": the second held-out draw, made after the cost tables were in
#: code, leaving out the sizes they were measured at; "fit3" and "held3":
#: after the tables were refit where K15's tile form took the halves on
#: 36864 and 49152, the composites whose way moved and two that kept it,
#: and a third held-out draw, seed 20261027)
R4_MISSES = {"fit": set(), "held": set(), "held2": set(), "fit3": set(), "held3": set()}

#: the JAX package's hole-band settings (rustfft_tpu/config.py:183-185)
JAX_BAND = dict(bconv_misaligned=True, bconv_misaligned_min_n=8192,
                bconv_misaligned_max_pad=3.5)


def _rows(table, rule_set):
    return [row for row in table if row[1] == rule_set]


def _recipe(kind, m):
    return ("Raders" if kind == "r" else "Bluesteins", m)


def _shape(recipe):
    """(class name, inner length) of a Raders or Bluesteins recipe."""
    return type(recipe).__name__, recipe.inner.length


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(C64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


@pytest.fixture
def fields():
    """Set port config fields for one test; every one set back after."""
    old = {}

    def set_(**kw):
        for k, v in kw.items():
            old.setdefault(k, getattr(config, k))
            setattr(config, k, v)

    yield set_
    for k, v in old.items():
        setattr(config, k, v)


@pytest.fixture
def ref_pallas():
    """Set the JAX package's use_pallas for one test; set back after."""
    old = ref_config.use_pallas

    def set_(mode):
        ref_config.use_pallas = mode

    yield set_
    ref_config.use_pallas = old


# -- the decisions against the measured table ------------------------------------

@pytest.mark.parametrize("rule_set", ["fit", "held"])
def test_prime_rule_takes_the_faster_way(rule_set):
    """R1 is on: at every sampled and held-out prime the card measured the
    Bluestein on a fast core form faster, and the planner takes it in place
    of the recipe of the convolution-core rules, whose inner runs K14's four
    stages."""
    planner = FftPlannerGpu(C64, device="cpu")
    rows = _rows(R1_TABLE, rule_set)
    assert len(rows) >= (40 if rule_set == "fit" else 10)
    for n, _, kind, m, m_new, way in rows:
        assert way == "new", n
        old = planner._conv_prime_recipe(n)
        assert _shape(old) == _recipe(kind, m), n
        assert executor.core_form("rader" if kind == "r" else "bluestein", m, C64) == \
            "K14 four stages", n
        assert routed_bluestein_inner(n, C64) == m_new
        assert executor.core_form("bluestein", m_new, C64) in FAST_FORMS
        assert _shape(planner.design_fft_for_len(n)) == ("Bluesteins", m_new), n
        assert route(n, C64) is None


@pytest.mark.parametrize("rule_set", ["fit", "held"])
def test_hole_band_is_off_as_measured(rule_set, fields):
    """R2 is off: the planner keeps large_pad, the parent's route, at every
    measured size; with config.bconv_misaligned on the route leaves them and
    the planner takes the Bluestein of the measured inner length."""
    rows = _rows(R2_TABLE, rule_set)
    assert len(rows) >= 10
    assert config.bconv_misaligned is False
    planner = FftPlanner(C64, device="cpu")
    gpu = FftPlannerGpu(C64, device="cpu")
    for n, _, m, _ in rows:
        assert route(n, C64) == "large_pad" and executor.hole_band_inner(n, C64) is None
        # the parent's recipe: the awkward-composite Bluestein, else the
        # near-balanced split (large_pad runs either)
        factors = PrimeFactors.compute(n)
        recipe = planner.design_fft_for_len(n)
        if factors.has_factors_gt(config.dense_dft_max):
            assert _shape(recipe) == ("Bluesteins", gpu._conv_inner(n)), n
        else:
            assert isinstance(recipe, recipes.MixedRadix), n
            assert recipe.left.length == FftPlannerGpu._choose_left_factor(n, factors), n
    fields(bconv_misaligned=True)
    for n, _, m, _ in rows:
        assert route(n, C64) is None and executor.hole_band_inner(n, C64) == m
        assert _shape(planner.design_fft_for_len(n)) == ("Bluesteins", m)
        assert route(n, C64, hole_band=False) == "large_pad"


def test_hole_band_has_no_pad_cap_without_a_loss():
    """Why R2 is off: the JAX rule is stated by a pad cap, and every cap that
    takes the sizes where the card measured the Bluestein faster also takes
    one where it measured large_pad faster (63535 wins at pad 2.06 and 28251
    at 2.32, 131047 loses at 2.0003)."""
    pad = {n: m / n for n, _, m, _ in R2_TABLE}
    wins = [n for n, _, _, way in R2_TABLE if way == "new"]
    losses = [n for n, _, _, way in R2_TABLE if way == "old"]
    assert sorted(wins) == [16383, 28251, 32767, 63535, 65535]
    assert max(pad[n] for n in wins) > min(pad[n] for n in losses)
    assert min(pad[n] for n in losses) < pad[63535] < pad[28251] < 3.5


@pytest.mark.parametrize("rule_set", ["fit", "held"])
def test_dense_band_is_off_as_measured(rule_set, fields):
    """R3 is off: dense_fft was slower at every measured size, and the
    route leaves them to the planner's convolution cores; with
    config.dense_fallback_max_n = 2048 they route dense."""
    rows = _rows(R3_TABLE, rule_set)
    assert len(rows) >= 10 and all(way == "old" for *_, way in rows)
    assert config.dense_fallback_max_n == 0
    planner = FftPlanner(C64, device="cpu")
    for n, _, kind, m, _ in rows:
        assert route(n, C64) is None
        assert _shape(planner.design_fft_for_len(n)) == _recipe(kind, m)
    fields(dense_fallback_max_n=2048)
    for n, _, kind, m, _ in rows:
        assert route(n, C64) == "dense"
        assert _shape(planner.design_fft_for_len(n)) == _recipe(kind, m)


def test_dense_band_sizes():
    """The band R3 would take: the 442 sizes of [257, 2048] that no other
    route serves, 255 of them primes."""
    from rustfft_tpu_torch.math_utils import is_prime

    band = [n for n in range(257, 2049) if route(n, C64) is None]
    assert len(band) == 442 and sum(map(is_prime, band)) == 255
    assert band[0] == 257 and band[-1] == 2042


@pytest.mark.parametrize("rule_set", ["fit", "held", "held2", "fit3", "held3"])
def test_composite_rule_takes_the_faster_way(rule_set):
    """R4 is on: at every sampled and held-out composite the recipe of the
    awkward-composite rules ran K14's four stages, no route serves n, and
    the planner takes the table's way: the Bluestein on routed_bluestein_inner
    (a fast core form) or the near-balanced split, whose DFT_p is a matmul
    leaf and whose prime half, a Raders or a Bluesteins with no route, has
    its cost in split_costs.CORE_NS.  The card measured that way the
    faster, or level, at every size but R4_MISSES."""
    planner = FftPlannerGpu(C64, device="cpu")
    rows = _rows(R4_TABLE, rule_set)
    assert len(rows) >= {"fit": 40, "held": 10, "held2": 20, "fit3": 6, "held3": 10}[rule_set]
    misses = set()
    for n, _, m_old, way, value, faster in rows:
        old = planner._conv_composite_recipe(n)
        assert _shape(old) == ("Bluesteins", m_old), n
        assert executor.core_form("bluestein", m_old, C64) == "K14 four stages", n
        assert route(n, C64) is None
        recipe = planner.design_fft_for_len(n)
        assert planner.composite_way(n) == {"b": "bluestein", "s": "split"}[way], n
        if way == "b":
            assert _shape(recipe) == ("Bluesteins", value) == ("Bluesteins",
                                                             routed_bluestein_inner(n, C64)), n
            assert executor.core_form("bluestein", value, C64) in FAST_FORMS
        else:
            assert isinstance(recipe, recipes.MixedRadix) and recipe.left.length == value, n
            assert value <= config.dense_dft_max and isinstance(recipe.left, recipes.Dft)
            half = recipe.right
            kind = {recipes.Raders: "rader", recipes.Bluesteins: "bluestein"}[type(half)]
            assert route(half.length, C64) is None
            assert split_costs.core_ns(kind, half.inner.length) is not None, n
        if way not in faster.split("="):
            misses.add(n)
    assert misses == R4_MISSES[rule_set]


def test_composite_rule_compares_the_tables():
    """R4's way is the cheaper of split_costs.py's two costs: at 8199 = 9 x
    911 the split (9 one-pass Bluesteins at m = 2048 and 8199 elements of
    glue) under the cluster passes' Bluestein at m = 32768; at 8482 = 2 x
    4241 the Bluestein, the split's two cluster-pass halves at m = 16384
    dearer; at 98324 = 188 x 523, whose split's DFT_p is a matmul leaf, the
    Bluestein as the tables price it; a size whose near-balanced split has
    p above config.dense_dft_max (no matmul leaf, no glue measured) takes
    the Bluestein."""
    planner = FftPlannerGpu(C64, device="cpu")
    cases = {8199: (9, "bluestein", 2048, 32768), 8482: (2, "bluestein", 16384, 32768),
             98324: (188, "bluestein", 1152, 262144)}
    for n, (p, kind, m_q, m_a) in cases.items():
        assert routed_bluestein_inner(n, C64) == m_a
        split = planner._split(n, PrimeFactors.compute(n))
        assert (split.left.length, split.right.inner.length) == (p, m_q), n
        cost = split_costs.split_ns(p, n, kind, m_q)
        assert cost == p * split_costs.CORE_NS[(kind, m_q)] + n * split_costs.GLUE_PS[p] / 1e3
        want = "split" if cost < split_costs.core_ns("bluestein", m_a) else "bluestein"
        assert planner.composite_way(n) == want, n
    assert [planner.composite_way(n) for n in cases] == ["split", "bluestein", "bluestein"]
    wide = next(n for n in range(8192 * 16, 1 << 20)
                if planner._choose_left_factor(n, PrimeFactors.compute(n)) > config.dense_dft_max
                and planner.composite_way(n) is not None)
    assert planner.composite_way(wide) == "bluestein"
    assert split_costs.split_ns(300, wide, "bluestein", 1152) is None


def test_split_costs_tables():
    """split_costs.py's tables cover what the rule asks of them: the CT glue
    at every p of 2 .. dense_dft_max, the cores at every inner length of
    the Bluestein the rule compares (routed_bluestein_inner's m_a: the
    cluster passes at r = 2 .. 16 and K15's tile form at 393216 and
    442368), each cost positive; a cost of no measured class is None."""
    assert sorted(split_costs.GLUE_PS) == list(range(2, config.dense_dft_max + 1))
    for m in (32768, 65536, 131072, 262144, 393216, 442368):
        assert split_costs.core_ns("bluestein", m) > 0
    assert all(v > 0 for v in split_costs.CORE_NS.values())
    assert all(kind in ("rader", "bluestein") for kind, _ in split_costs.CORE_NS)
    assert split_costs.core_ns("bluestein", 15552) is None  # K14's four stages: not a half
    assert split_costs.split_ns(1, 8192, "bluestein", 2048) is None


def test_composite_rule_gates(fields):
    """R4's gates leave the recipe alone: complex128 and the kernels off
    design the JAX package's split, a pinned plan runs its literal Bluestein
    on the four stages' inner length, a composite a route serves (32769 on
    large_pad) keeps its unbuilt whole-n Bluestein, and so do composites
    whose Bluestein runs another core (the hole band's, with its field on,
    on the cluster passes)."""
    from rustfft_tpu_torch import algorithm

    n, m_old = 8199, 17496
    assert _shape(FftPlannerGpu(C64, device="cpu")._conv_composite_recipe(n)) == \
        ("Bluesteins", m_old)
    split = FftPlannerGpu(np.complex128, device="cpu").design_fft_for_len(n)
    assert isinstance(split, recipes.MixedRadix) and split.left.length == 9
    fields(kernels="off")
    assert FftPlannerGpu(C64, device="cpu").design_fft_for_len(n) == split
    fields(kernels="auto")
    planner = FftPlanner(C64, device="cpu")
    pinned = algorithm.BluesteinsAlgorithm(n, planner.plan_fft_forward(m_old))
    assert pinned.pinned and _shape(pinned.recipe) == ("Bluesteins", m_old)
    gpu = FftPlannerGpu(C64, device="cpu")
    assert route(32769, C64) == "large_pad"
    assert gpu.design_fft_for_len(32769) == gpu._conv_composite_recipe(32769)
    assert executor.core_form("bluestein", gpu._conv_inner(32769), C64) == "K14 four stages"
    fields(**JAX_BAND)
    band = FftPlannerGpu(C64, device="cpu")
    for n in (16383, 32767):  # the hole band's Bluesteins, on the cluster passes
        assert route(n, C64) is None
        assert band.design_fft_for_len(n) == band._conv_composite_recipe(n)
        assert _shape(band.design_fft_for_len(n)) == ("Bluesteins",
                                                      executor.hole_band_inner(n, C64))


# -- the hole band against the JAX planner ----------------------------------------

def test_hole_band_inner_matches_jax(fields, ref_pallas):
    """With the JAX settings, hole_band_inner equals FftPlannerTpu's
    _radix_conv_inner (in interpret mode) at every odd n of [8193, 131071]
    that route would give large_pad, wherever the JAX helper returns an
    inner length (15988 sizes), and is None elsewhere."""
    fields(**JAX_BAND)
    ref_pallas("on")
    ref = FftPlannerTpu(C64)
    matched = 0
    for n in range(8193, 131073, 2):
        if route(n, C64, hole_band=False) != "large_pad":
            continue
        m = ref._radix_conv_inner(n)
        assert executor.hole_band_inner(n, C64) == m, n
        matched += m is not None
    assert matched == 15988


def test_hole_band_gates(fields):
    """The band's gates: the field, the kernels, c64, odd n, the floor, the
    pad cap and only sizes route would give large_pad."""
    fields(**JAX_BAND)
    assert executor.hole_band_inner(15625, C64) == 32768
    assert executor.hole_band_inner(15625, np.complex128) is None
    assert executor.hole_band_inner(16807, C64) is None  # pad 3.90
    assert executor.hole_band_inner(10000, C64) is None  # even
    assert executor.hole_band_inner(4096, C64) is None  # lanepack
    fields(bconv_misaligned_min_n=16384)
    assert executor.hole_band_inner(15625, C64) is None
    fields(bconv_misaligned_min_n=8192, kernels="off")
    assert executor.hole_band_inner(15625, C64) is None and route(15625, C64) is None
    fields(kernels="auto", bconv_misaligned_max_pad=2.0)
    assert executor.hole_band_inner(15625, C64) is None


def test_rule_fields_key_the_caches(fields):
    """The four fields join config.switch_key() and the planner's recipe
    cache key, so a recipe or plan made under one setting is not reused
    under another."""
    planner = FftPlanner(C64, device="cpu")
    default = planner.plan_fft_forward(16383)
    keys = config.switch_key(), planner._recipe_cache_key()
    for name, value in (("dense_fallback_max_n", 2048), ("bconv_misaligned", True),
                        ("bconv_misaligned_min_n", 4096), ("bconv_misaligned_max_pad", 3.0)):
        old = getattr(config, name)
        fields(**{name: value})
        assert config.switch_key() != keys[0] and planner._recipe_cache_key() != keys[1], name
        fields(**{name: old})
    assert (config.switch_key(), planner._recipe_cache_key()) == keys
    fields(bconv_misaligned=True)
    switched = planner.plan_fft_forward(16383)
    assert switched is not default and _shape(switched.recipe) == ("Bluesteins", 32768)
    fields(bconv_misaligned=False)
    assert planner.plan_fft_forward(16383) is default


# -- outputs against the JAX planner and the oracle ---------------------------------

#: (n, the fields its rule needs on): an R1 prime whose old inner runs the
#: four stages near 8192 (8209: Bluesteins at 17496 -> 32768), an R2 size and
#: three R3 sizes
OUTPUT_CASES = [(8209, {}), (16383, {"bconv_misaligned": True}),
                (257, {"dense_fallback_max_n": 2048}), (1031, {"dense_fallback_max_n": 2048}),
                (2042, {"dense_fallback_max_n": 2048})]


@pytest.mark.parametrize("n,on", OUTPUT_CASES, ids=[str(n) for n, _ in OUTPUT_CASES])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_rule_paths_match_jax_and_oracle(n, on, direction, fields, ref_pallas):
    """The rule's path (the plain versions of its kernels on the CPU)
    against the JAX FftPlanner with Pallas off and the float64 oracle."""
    fields(**on)
    ref_pallas("off")
    d = FftDirection(direction)
    planner = FftPlanner(C64, device="cpu")
    plan = planner.plan_fft(n, d)
    if on.get("dense_fallback_max_n"):
        assert route(n, C64) == "dense"
    else:
        assert isinstance(plan.recipe, recipes.Bluesteins) and route(n, C64) is None
    x = _signal(2, n, seed=n)
    got = plan.process(torch.from_numpy(x)).numpy()
    ref_plan = rustfft_tpu.FftPlanner(C64).plan_fft(n, RefDirection(direction))
    want = np.asarray(ref_plan.process(x))
    assert _rel(got, want) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


#: R4's ways on the CPU: the split at 8199 = 9 x 911 (half a Bluesteins on
#: the one-pass core) and 41484 = 12 x 3457 (half a Raders on it), the
#: Bluestein on the cluster passes at 9532 and 8482 (m = 32768) and on K15's
#: tile form at 131084 (m = 393216)
R4_OUTPUT_CASES = (8199, 9532, 8482, 131084, 41484)


@pytest.mark.parametrize("n", R4_OUTPUT_CASES)
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_composite_rule_paths_match_jax_and_oracle(n, direction, ref_pallas):
    """The composite rule's path (the plain versions of its kernels on the
    CPU) against the JAX FftPlanner with Pallas off and the float64
    oracle."""
    ref_pallas("off")
    d = FftDirection(direction)
    plan = FftPlanner(C64, device="cpu").plan_fft(n, d)
    way = {row[0]: row[3] for row in R4_TABLE}[n]
    assert isinstance(plan.recipe, recipes.MixedRadix if way == "s" else recipes.Bluesteins)
    x = _signal(2, n, seed=n)
    got = plan.process(torch.from_numpy(x)).numpy()
    want = np.asarray(rustfft_tpu.FftPlanner(C64).plan_fft(n, RefDirection(direction)).process(x))
    assert _rel(got, want) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


# -- R5, the core rule above 2^20 ------------------------------------------------------

#: R5: (n, set, class, the core's ms without the rule, the glued form's ms
#: (queued device time; None for B23, glued either way), the faster way by
#: more than the spread of the turns: "new" the glued form, "old" the core).
#: B3a's and B3b's are the rerun with their core on K15's tile form
#: (PLANNER_RULES_GPU.md's second R5 table); the general form before it ran
#: 13.42-13.65 and 17.04-17.59 ms against the same glued form)
R5_TABLE = (
    (1572869, "fit", "B22", 18.754, 7.460, "new"), (1677089, "fit", "B22", 18.843, 7.560, "new"),
    (1781851, "fit", "B22", 19.028, 7.652, "new"), (1886173, "fit", "B22", 19.082, 7.752, "new"),
    (1991723, "fit", "B22", 19.124, 7.846, "new"), (2097143, "fit", "B22", 19.109, 7.934, "new"),
    (1766363, "held", "B22", 18.893, 7.638, "new"), (1889191, "held", "B22", 19.002, 7.746, "new"),
    (1901803, "held", "B22", 18.986, 7.759, "new"), (1984711, "held", "B22", 19.075, 7.833, "new"),
    (1051009, "fit", "R4S", 5.921, 6.553, "old"), (1470977, "fit", "R4S", 9.788, 10.382, "old"),
    (2003761, "fit", "R4S", 14.159, 16.843, "old"), (2603371, "fit", "R4S", 11.360, 12.424, "old"),
    (3342223, "fit", "R4S", 14.871, 15.522, "old"), (4193377, "fit", "R4S", 20.006, 20.910, "old"),
    (1074061, "held", "R4S", 6.140, 6.667, "old"), (1088641, "held", "R4S", 5.905, 6.312, "old"),
    (1947457, "held", "R4S", 11.517, 13.391, "old"), (2184001, "held", "R4S", 7.862, 8.492, "old"),
    (1048583, "fit", "B3a", 3.004, 14.858, "old"), (1152517, "fit", "B3a", 3.018, 14.939, "old"),
    (1256821, "fit", "B3a", 3.123, 15.018, "old"), (1361699, "fit", "B3a", 3.132, 15.146, "old"),
    (1466741, "fit", "B3a", 3.195, 15.256, "old"), (1572853, "fit", "B3a", 3.232, 15.389, "old"),
    (1226959, "held", "B3a", 3.116, 15.047, "old"),
    (1378439, "held", "B3a", 3.180, 15.190, "old"),
    (1447217, "held", "B3a", 3.232, 15.265, "old"),
    (1556083, "held", "B3a", 3.263, 15.381, "old"), (2097169, "fit", "B3b", 3.791, 21.901, "old"),
    (2304283, "fit", "B3b", 3.852, 21.987, "old"), (2513617, "fit", "B3b", 3.902, 22.099, "old"),
    (2722877, "fit", "B3b", 3.954, 22.161, "old"), (2933803, "fit", "B3b", 4.015, 22.262, "old"),
    (3145721, "fit", "B3b", 4.061, 22.353, "old"), (2370223, "held", "B3b", 3.862, 22.018, "old"),
    (2378197, "held", "B3b", 3.864, 22.025, "old"),
    (2710177, "held", "B3b", 3.947, 22.162, "old"),
    (2816839, "held", "B3b", 3.972, 22.214, "old"), (3145739, "fit", "B23", 7.640, None, "old"),
    (3353209, "fit", "B23", 7.726, None, "old"), (3563479, "fit", "B23", 7.817, None, "old"),
    (3772753, "fit", "B23", 7.912, None, "old"), (3983009, "fit", "B23", 7.998, None, "old"),
    (4194301, "fit", "B23", 8.096, None, "old"), (3474161, "held", "B23", 7.784, None, "old"),
    (3838979, "held", "B23", 7.945, None, "old"), (4072949, "held", "B23", 8.034, None, "old"),
    (4188043, "held", "B23", 8.095, None, "old"),
)

#: R5's classes of primes of (2^20, 2^22]: (kind, the core without the rule,
#: one prime); B23's Bluestein on 2^23 is glued either way
R5_CLASSES = {"B22": ("bluestein", "K14 four stages", 1572869),
              "R4S": ("rader", "K14 four stages", 1051009),
              "B3a": ("bluestein", "K15 tile form", 1048583),
              "B3b": ("bluestein", "K15 tile form", 2097169),
              "B23": ("bluestein", "glued form", 4194301)}


def _kind(recipe):
    return "rader" if isinstance(recipe, recipes.Raders) else "bluestein"


@pytest.mark.parametrize("cls", list(R5_CLASSES))
def test_core_rule_takes_the_faster_way(cls):
    """R5 moves a class onto the glued form where the card measured it the
    faster at every sampled and held-out prime, and keeps the core
    elsewhere; the recipe stays the planner's (R5 is the executor's).  B23
    was timed against torch.fft only."""
    kind, before, _ = R5_CLASSES[cls]
    planner = FftPlannerGpu(C64, device="cpu")
    rows = [row for row in R5_TABLE if row[2] == cls]
    assert len(_rows(rows, "fit")) >= 6 and len(_rows(rows, "held")) >= 4, cls
    glued = all(row[5] == "new" for row in rows)
    for n, _, _, core_ms, glued_ms, way in rows:
        recipe = planner.design_fft_for_len(n)
        assert recipe == planner._conv_prime_recipe(n) and route(n, C64) is None, n
        assert _kind(recipe) == kind, n
        m = recipe.inner.length
        assert executor.core_form(kind, m, C64, core_rule=False) == before, n
        if cls == "B23":
            assert way == "old" and glued_ms is None
            assert executor.core_form(kind, m, C64) == "glued form"
            continue
        assert (way == "new") == (glued_ms < core_ms), n
        assert executor.core_form(kind, m, C64) == ("glued form" if glued else before), n


@pytest.mark.parametrize("cls", list(R5_CLASSES))
def test_core_form_of_each_class(cls):
    """Each class's prime gets the measured form from core_form, and
    executor.build follows it: the glued form is ops/bluestein.py's or
    ops/raders.py's function; core_rule=False builds the core it replaced."""
    kind, before, n = R5_CLASSES[cls]
    recipe = FftPlannerGpu(C64, device="cpu").design_fft_for_len(n)
    m = recipe.inner.length
    assert m > executor.CORE_RULE_MIN_M
    measured = {row[5] for row in R5_TABLE if row[2] == cls} == {"new"} or cls == "B23"
    form = executor.core_form(kind, m, C64)
    assert form == ("glued form" if measured else before)
    assert executor.core_form(kind, m, C64, core_rule=False) == before
    glued = "rustfft_tpu_torch.ops." + ("raders" if kind == "rader" else "bluestein")
    fn = executor.build(recipe, FftDirection.FORWARD, C64)
    assert (fn.__module__ == glued) == (form == "glued form")
    if before == "K15 tile form":
        assert fn.__module__ == "rustfft_tpu_torch.ops.kernels.convlarge"
    if form != before:
        old = executor.build(recipe, FftDirection.FORWARD, C64, core_rule=False)
        assert old.__module__ == "rustfft_tpu_torch.ops.kernels.conv_radix"
        # complex128 takes no kernel core: the glued form with or without the rule
        assert executor.build(recipe, FftDirection.FORWARD, np.complex128).__module__ == glued


def test_core_rule_recipes_match_jax():
    """R5 changes no recipe: at one prime of each class both planners' recipes
    equal the JAX FftPlanner's."""
    ref = rustfft_tpu.FftPlanner(C64)
    for _, _, n in R5_CLASSES.values():
        want = repr(ref.design_fft_for_len(n))
        assert repr(FftPlanner(C64, device="cpu").design_fft_for_len(n)) == want, n
        assert repr(FftPlannerGpu(C64, device="cpu").design_fft_for_len(n)) == want, n


#: one prime of each class R5 decided and a direction (both directions over
#: the four): B22's glued form, R4S's four stages, B3a's and B3b's K15
#: tile form
R5_OUTPUT_CASES = (("B22", "forward"), ("R4S", "inverse"), ("B3a", "inverse"), ("B3b", "forward"))


@pytest.mark.parametrize("cls,direction", R5_OUTPUT_CASES,
                         ids=[f"{c}-{d}" for c, d in R5_OUTPUT_CASES])
def test_core_rule_paths_match_jax_and_oracle(cls, direction, ref_pallas):
    """The planner's path at batch 1 (the plain versions of the inner's
    kernels on the CPU) against the JAX FftPlanner with Pallas off and the
    float64 oracle; a Rader's DC bin against the input's float64 sum."""
    ref_pallas("off")
    n = R5_CLASSES[cls][2]
    d = FftDirection(direction)
    plan = FftPlanner(C64, device="cpu").plan_fft(n, d)
    x = _signal(1, n, seed=n)
    got = plan.process(torch.from_numpy(x)).numpy()
    want = np.asarray(rustfft_tpu.FftPlanner(C64).plan_fft(n, RefDirection(direction)).process(x))
    assert _rel(got, want) <= TOL
    oracle = host_dft(x, d)
    assert _rel(got, oracle) <= TOL
    if cls == "R4S":
        total = x.astype(np.complex128).sum(axis=-1)
        assert np.all(np.abs(got[:, 0] - total) <= TOL * np.abs(total))


# -- the kernels off and complex128 --------------------------------------------------

NEW_SIZES = sorted({row[0] for table in (R1_TABLE, R2_TABLE, R3_TABLE, R4_TABLE)
                    for row in table})


@pytest.mark.parametrize("dtype", ["c64 kernels off", "c128"])
@pytest.mark.parametrize("rules", ["default", "every rule on"])
def test_recipes_without_kernels_match_jax(dtype, rules, fields, ref_pallas):
    """With the kernels off (c64) and for complex128 no rule acts: at every
    size of the tables the recipe equals the JAX package's with Pallas off,
    the rules' fields on or off."""
    if rules != "default":
        fields(**JAX_BAND, dense_fallback_max_n=2048)
    np_dtype = C64
    if dtype == "c128":
        np_dtype = np.complex128
    else:
        fields(kernels="off")
    ref_pallas("off")
    port = FftPlanner(np_dtype, device="cpu")
    ref = rustfft_tpu.FftPlanner(np_dtype)
    for n in NEW_SIZES:
        assert repr(port.design_fft_for_len(n)) == repr(ref.design_fft_for_len(n)), n
        assert route(n, np_dtype) is None
