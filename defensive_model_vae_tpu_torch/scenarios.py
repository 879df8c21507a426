"""Single scenario registry for all per-scenario constants.

Port of ``defensive_model_vae_tpu/scenarios.py``, the whole registry: every
field of ``Scenario`` (:65) and every entry of ``REGISTRY`` (:353-545) — the
dataset, start-condition, human and SUT predicates, the trim modes and masks,
the grids, the THW distances, the plotting and DNDA constants,
``published_best`` and ``provenance_notes`` — plus ``ACTIONS``,
``DATASET_ACTIONS``, ``get`` and ``keys``.

The reference scatters per-scenario magic constants across >=6 files and
dispatches on substrings of model filenames (see reference ``Tools.py:84-97``,
``Spatial_Distribution.py:360-384``, ``Distribution.py:83-92``,
``Traj_Data_Process.py:8-28``).  This module centralizes every one of those
constants in a typed registry keyed by scenario id (``sce1``..``sce4``) so the
rest of the framework never needs string matching on filenames.

Scenario ids and town names (reference ``SUT_Testing/Defensive_Testing.py:21-26``):
    sce1 = StaticBlindTown05
    sce2 = DynamicBlindTown05
    sce3 = PredictableMovementTown05
    sce4 = UnpredictableMovementTown04

All predicates operate on the port's column table (``data.csv_io.Frame``:
column names over a float64 matrix) with the CARLA log schema
(``frame,id,throttle,steer,brake,ego_x..ego_yaw,sv1_x..sv6_yaw``): a column
is a float64 array, so the JAX predicates' ``.astype(float)`` casts are
dropped, and a mask is a boolean array.  Row predicates (``dataset_end_row``,
the DNDA stop functions) also take one ``Frame`` row.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO_ROOT / "fixtures"

Predicate = Callable[["Frame"], np.ndarray]  # noqa: F821


@dataclasses.dataclass(frozen=True)
class LaneLine:
    """One painted lane line (always axis-aligned in the four scenarios)."""

    axis: str  # 'x' means vertical line at x=value; 'y' horizontal at y=value
    value: float
    style: str  # 'solid' | 'dashed'
    span: Tuple[float, float]  # extent along the other axis


@dataclasses.dataclass(frozen=True)
class DndaConfig:
    """Per-scenario DNDA driver configuration.

    Mirrors the straight-line baselines and lane configuration of the
    reference ``SUT_Testing/tools/DNDA_calculator.py:38-78,105-135``.
    """

    lane_num: int
    lane_egodirect: int
    lane_width: float = 3.5
    max_absolute_acc: float = 9.8
    # Baseline generator: returns flat [x1,y1,x2,y2,...] array, 0.25 m spacing.
    baseline_fn: Callable[[], np.ndarray] = None  # type: ignore[assignment]
    # Surrounding vehicles rendered as bicycles (2.0 m × 0.7 m instead of
    # 4.0 m × 2.0 m) — reference ``generate_surVhe_input`` special-cases
    # sce1's sv2 and sce3's sv1 (``DNDA_calculator.py:176-207``).
    bike_svs: Tuple[int, ...] = ()
    # Episode stop predicate over one CSV row mapping (reference
    # ``process_file`` per-scenario stop conditions, ``:317-338``).
    stop_fn: Callable[["FrameRow"], bool] = None  # type: ignore[assignment]  # noqa: F821


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Everything the framework knows about one driving scenario."""

    key: str  # 'sce1'..'sce4'
    town: str  # CARLA town folder name
    index: int  # 1..4

    # --- time discretization (reference Tools.py:155-164) ---
    dt: float  # simulation / tracking time step in seconds

    # --- dataset extraction (reference Traj_Data_Process.py:8-28) ---
    dataset_start: Predicate
    # accepts a single row OR a whole Frame (use `&`, never `and`):
    # process_csv evaluates it vectorized over the post-start tail
    dataset_end_row: Callable[["FrameRow"], bool]  # noqa: F821

    # --- start-condition mask (reference Tools.py:84-97) ---
    start_condition_mask: Predicate
    start_fallback: Tuple[float, float, float]  # (x, y, angle_rad)

    # --- human/background-vehicle extraction (reference Tools.py:153-178) ---
    human_start_mask: Predicate
    human_end_mask: Predicate
    n_background_vehicles: int  # how many sv tracks to return (1 or 2)

    # --- human-velocity trimming (reference Distribution.py:228-243) ---
    # mask over human [x, y, t] rows selecting the analysed segment
    human_trim_mode: str  # 'sce1_splice' | 'first_index'
    human_trim_mask: Callable[[np.ndarray], np.ndarray]

    # --- validation grids (reference Spatial_Distribution.py:360-384) ---
    grid_x: Tuple[float, float]  # arange(start, stop, grid_size)
    grid_y: Tuple[float, float]

    # --- plotting (reference Plot_Gif.py / Tools.py:318-368) ---
    plot_xlim: Tuple[float, float]
    plot_ylim: Tuple[float, float]
    lane_lines: Tuple[LaneLine, ...]
    axis_flip: str  # which axes the reference inverts for display

    # --- THW (reference Get_THW.py:66-104) ---
    # distance / start_speed; sce4 uses 40 m when trial suffix == '3' else 30 m
    thw_distance: Optional[float]
    thw_distance_by_suffix: Optional[Dict[str, float]]

    # --- SUT episode slicing (reference Metrics_Calculation.py:143-210) ---
    # NOTE: only the jerk axis lives here; the rest of the SUT fields sit
    # in the defaulted block below (dataclass ordering: non-default fields
    # cannot follow defaulted ones)
    sut_jerk_axis: str  # 'ax' | 'ay'

    # --- DNDA (reference DNDA_calculator.py) ---
    dnda: DndaConfig = None  # type: ignore[assignment]

    # Optional ARTIFACT-variant dataset start: the extraction predicate the
    # published results were actually trained with, where it provably
    # differs from the shipped Traj_Data_Process.py one.  sce1 only: the
    # published GeneratedData implies training windows starting at
    # ego_y>=40 (decoded path length ≈ the y40→95 human corridor; the
    # shipped trajectory_sce1_cond.npy and its y>=18 predicate postdate the
    # artifacts, like the Tools.py start-mask — see _sce1_generation_start).
    artifact_dataset_start: Optional[Predicate] = None

    # Scenario-specific caveats embedded into every validation artifact's
    # provenance block (pipeline.provenance)
    provenance_notes: Tuple[str, ...] = ()

    # Best published end-to-end validation values for this scenario
    # (reference results/ModelValidation/JS_divergence.txt; sce3 JS at
    # n=66, sce4 surface = the curated-best "0211" run).  The selection
    # sweeps and parity scoreboards compare against these.
    published_best: Optional[Dict[str, float]] = None

    # --- SUT episode slicing, continued (see sut_jerk_axis above) ---
    sut_episode_start: Optional[Predicate] = None
    sut_episode_end: Optional[Predicate] = None
    # 1-D TTC configuration (reference ``:213-249``): lead-vehicle column
    # prefix and the axis the scenario closes along
    sut_ttc_vehicle: str = "sv1"
    sut_ttc_axis: str = "y"
    # PET conflict partner (reference ``add_pet_column``, ``:277-286``:
    # sv2 for sce1/sce2, sv1 for sce3/sce4)
    pet_partner: str = "sv1"
    # space axis of the space-time-velocity surface = the axis the
    # scenario drives along (reference Spatial_Distribution.py STV plots)
    stv_axis: str = "y"

    # --- display conventions ---
    # lane CENTERLINE for the lateral-offset curves — (axis, coordinate),
    # the reference's hardcoded centers (Plot_Gif.py:327-338: sce1
    # x=-195.05, sce2 y=-0.55, sce3 x=155.05, sce4 x=16.25) — NOT one of
    # the painted lane lines
    lateral_offset_center: Tuple[str, float] = ("x", 0.0)
    # first background vehicle's rendered footprint (sce3's is a bicycle,
    # reference Tools.py:397-400)
    bv1_plot_size: Tuple[float, float] = (4.0, 2.0)
    # the reference inverts the STV coordinate axis for every scenario but
    # sce1 (Spatial_Distribution.py display convention)
    stv_invert_axis: bool = True

    @property
    def fixture_windows(self) -> pathlib.Path:
        """The committed (N, 10, 3) [t, x, y] training windows."""
        return FIXTURES / f"trajectory_{self.key}_cond.npy"


# ---------------------------------------------------------------------------
# DNDA straight-line baselines (reference DNDA_calculator.py:38-78)
# ---------------------------------------------------------------------------

def _baseline_sce1() -> np.ndarray:
    x = -189.81
    y_values = np.arange(-80, 300, 0.25)
    return np.stack([np.full_like(y_values, x), y_values], axis=1).ravel()


def _baseline_sce2() -> np.ndarray:
    x_values = np.arange(20.5, -350, -0.25)
    slope = (1.23 - 0.92) / (-177.3 - (-50))
    intercept = 0.92 - slope * (-50)
    return np.stack([x_values, slope * x_values + intercept], axis=1).ravel()


def _baseline_sce3() -> np.ndarray:
    y_values = np.arange(100.5, -300, -0.25)
    x = 153.33
    return np.stack([np.full_like(y_values, x), y_values], axis=1).ravel()


def _baseline_sce4() -> np.ndarray:
    y_values = np.arange(210.5, -450, -0.25)
    slope = (220 - (-160)) / (7.77 - 6.06)
    intercept = 220 - slope * 7.77
    x_values = y_values / slope - intercept / slope
    return np.stack([x_values, y_values], axis=1).ravel()


# ---------------------------------------------------------------------------
# DNDA episode stop predicates (reference ``process_file``,
# ``DNDA_calculator.py:317-338``) — evaluated per CSV row; True ends the
# episode before scoring that frame.
# ---------------------------------------------------------------------------

def _dnda_stop_sce1(row) -> bool:
    return row["ego_y"] >= 80


def _dnda_stop_sce2(row) -> bool:
    return row["ego_x"] <= -186.8897


def _dnda_stop_sce3(row) -> bool:
    return row["ego_y"] <= -78


def _dnda_stop_sce4(row) -> bool:
    # stop once sv1 has completed its turn (x > 14, yaw ≈ −90°) or the ego
    # has left the corridor
    sv1_x = row.get("sv1_x", np.nan)
    sv1_yaw = row.get("sv1_yaw", np.nan)
    if not (np.isnan(sv1_x) or np.isnan(sv1_yaw)):
        if sv1_x > 14 and abs(sv1_yaw - (-90)) < 3:
            return True
    return row["ego_y"] <= -160


# ---------------------------------------------------------------------------
# Predicates.  Each mirrors the cited reference mask exactly.
# ---------------------------------------------------------------------------

def _sce1_dataset_start(df):
    return (df["ego_y"] >= 18) & (df["sv2_vx"] != 0) & (df["sv2_vy"] != 0)


def _sce1_generation_start(df):
    """sce1 start mask for GENERATION (``Plot_Gif.py:82``: ``ego_y >= 40``).

    The reference tree carries two divergent sce1 start masks (SURVEY §5):
    ``Tools.py:85`` (``ego_y >= 18 & sv2 moving``) and ``Plot_Gif.py:82``
    (``ego_y >= 40``).  The published artifacts settle which one produced
    them: 37/38 shipped ``results/GeneratedData/*sce1*.npy`` traces start
    EXACTLY (to 1e-3 in x, y, yaw, and speed) at the first ``ego_y >= 40``
    row of their source CSV, and 0/38 match the Tools.py mask (the 38th is
    a visibly broken runaway trace).  The y>=40 convention is also the one
    the rest of the published workflow assumes: the human-velocity trim is
    ``y >= 40`` (``Distribution.py:264``) and the sce1 metric grid starts at
    y=40 (``Spatial_Distribution.py:363``).  The Tools.py variant matches
    the TRAINING-window extraction (``Traj_Data_Process.py:10``) — shipped
    ``trajectory_sce1_cond.npy`` windows start at y≈19 — so it stays as
    ``dataset_start`` below, and generation uses this mask.  Closing this
    fork is what closes the published sce1 RMSE_frequency (2.44) gap.
    """
    return df["ego_y"] >= 40


def _sce2_dataset_start(df):
    return df["sv1_yaw"] < -170


def _sce3_dataset_start(df):
    return (
        (df["sv1_vx"] != 0)
        & (df["sv1_vy"] != 0)
        & (df["ego_y"] <= 40)
        & (df["ego_y"] != 0)
    )


def _sce4_dataset_start(df):
    return (
        (df["ego_x"] - df["sv1_x"]) ** 2 + (df["ego_y"] - df["sv1_y"]) ** 2
        <= 40.0 ** 2
    ) & (df["sv1_yaw"] >= -89.9)


# start-condition mask for generation (Tools.py:84-97): identical to the
# dataset masks except sce4 (same) — the human-extraction mask for sce4 uses a
# 50 m radius and drops the yaw condition (Tools.py:160).
def _sce4_human_start(df):
    return (
        (df["ego_x"] - df["sv1_x"]) ** 2 + (df["ego_y"] - df["sv1_y"]) ** 2
        <= 50.0 ** 2
    )


# SUT episode slicing predicates (reference Metrics_Calculation.py:143-210)
def _sce1_sut_start(df):
    return (
        (df["ego_y"] > 0)
        & (df["sv2_vx"] != 0)
        & (df["sv2_vy"] != 0)
    )


def _sce1_sut_end(df):
    return df["ego_y"] >= 80


def _sce2_sut_start(df):
    return df["sv1_yaw"] < -150


def _sce2_sut_end(df):
    return df["ego_x"] < -186.8897


def _sce3_sut_start(df):
    ey = df["ego_y"]
    return (
        (ey < 40)
        & (ey != 0)
        & (df["sv1_vx"] != 0)
        & (df["sv1_vy"] != 0)
    )


def _sce3_sut_end(df):
    return df["ego_y"] < -78


def _sce4_sut_start(df):
    dist = np.hypot(
        df["ego_x"] - df["sv1_x"],
        df["ego_y"] - df["sv1_y"],
    )
    return (dist <= 30) & (np.abs(df["sv1_ax"]) >= 0.1)


def _sce4_sut_end(df):
    return (
        (np.abs(df["sv1_ax"]) < 0.1)
        & (df["sv1_yaw"] < -90)
        & (df["sv1_ax"] != 0)
        & (df["sv1_x"] > 15)
    )


def _sce1_human_end(df):
    return df["ego_y"] >= 95


def _sce2_human_end(df):
    return df["ego_x"] < -186


def _sce3_human_end(df):
    return df["ego_y"] <= -80


def _sce4_human_end(df):
    return (df["sv1_x"] > 15) & (df["sv1_yaw"] < -85)


REGISTRY: Dict[str, Scenario] = {
    "sce1": Scenario(
        key="sce1",
        town="StaticBlindTown05",
        index=1,
        dt=0.02,
        dataset_start=_sce1_dataset_start,
        dataset_end_row=lambda row: row["ego_y"] >= 95,
        start_condition_mask=_sce1_generation_start,
        start_fallback=(-193.3, 50.0, -np.pi / 2),
        human_start_mask=_sce1_dataset_start,
        human_end_mask=_sce1_human_end,
        n_background_vehicles=2,
        human_trim_mode="sce1_splice",
        human_trim_mask=lambda traj: traj[:, 1] >= 40,
        grid_x=(-198, -188 + 1),
        grid_y=(40, 80 + 1),
        plot_xlim=(-230, -150),
        plot_ylim=(20, 100),
        lane_lines=(
            LaneLine("x", -196.8, "solid", (0, 73.2)),
            LaneLine("x", -193.3, "dashed", (0, 73.2)),
            LaneLine("x", -189.8, "solid", (0, 73.2)),
        ),
        axis_flip="x",
        thw_distance=60.0,
        thw_distance_by_suffix=None,
        sut_jerk_axis="ay",
        dnda=DndaConfig(
            lane_num=2, lane_egodirect=2, baseline_fn=_baseline_sce1,
            bike_svs=(2,), stop_fn=_dnda_stop_sce1,
        ),
        artifact_dataset_start=_sce1_generation_start,
        sut_episode_start=_sce1_sut_start,
        sut_episode_end=_sce1_sut_end,
        sut_ttc_vehicle="sv2",
        sut_ttc_axis="y",
        pet_partner="sv2",
        stv_invert_axis=False,
        lateral_offset_center=("x", -195.05),
        published_best={
            "velocity_js_divergence": 0.131582,
            "rmse_frequency_trajcount": 2.440675,
            "surface_rmse_with_zeros": 2.22687781,
            "surface_rmse_no_zeros": 2.36965596,
        },
    ),
    "sce2": Scenario(
        key="sce2",
        town="DynamicBlindTown05",
        index=2,
        dt=0.025,
        dataset_start=_sce2_dataset_start,
        dataset_end_row=lambda row: row["ego_x"] < -186,
        start_condition_mask=_sce2_dataset_start,
        start_fallback=(-155.0, -5.0, -np.pi / 2),
        human_start_mask=_sce2_dataset_start,
        human_end_mask=_sce2_human_end,
        n_background_vehicles=2,
        human_trim_mode="first_index",
        # PRESERVED QUIRK: x >= 40 is never true on this town (sce2's x
        # spans ~-200..-100) so the trim keeps the whole track — an exact
        # mirror of reference Distribution.py:230, almost certainly a
        # copy-paste of sce1's y>=40.  It is load-bearing for the sce2
        # velocity statistics / JS parity; do NOT "fix" it.
        human_trim_mask=lambda traj: traj[:, 0] >= 40,
        grid_x=(-200, -120),
        grid_y=(-8, 6),
        plot_xlim=(-200, -100),
        plot_ylim=(-53, 47),
        lane_lines=(
            LaneLine("y", -5.8, "solid", (-177, -50)),
            LaneLine("y", -2.3, "dashed", (-177, -50)),
            LaneLine("y", 1.2, "solid", (-177, -50)),
        ),
        axis_flip="x",
        # None on purpose: the reference's Get_THW has NO sce2 branch, and
        # `defvae thw` / metrics.thw must keep skipping sce2 to match it.
        # The conditioned corpus (BASELINE config 4) supplies its own
        # cross-scenario default via build_conditioned_corpus's
        # default_distance — not a per-scenario constant, so not here.
        thw_distance=None,
        thw_distance_by_suffix=None,
        sut_jerk_axis="ax",
        dnda=DndaConfig(
            lane_num=2, lane_egodirect=2, baseline_fn=_baseline_sce2,
            stop_fn=_dnda_stop_sce2,
        ),
        sut_episode_start=_sce2_sut_start,
        sut_episode_end=_sce2_sut_end,
        sut_ttc_vehicle="sv2",
        sut_ttc_axis="x",
        pet_partner="sv2",
        stv_axis="x",
        lateral_offset_center=("y", -0.55),
        published_best={
            "velocity_js_divergence": 0.112286,
            "rmse_frequency_trajcount": 1.685821,
            "surface_rmse_with_zeros": 1.41293849,
            "surface_rmse_no_zeros": 1.55854868,
        },
    ),
    "sce3": Scenario(
        key="sce3",
        town="PredictableMovementTown05",
        index=3,
        dt=0.015,
        dataset_start=_sce3_dataset_start,
        dataset_end_row=lambda row: row["ego_y"] <= -80,
        start_condition_mask=_sce3_dataset_start,
        start_fallback=(155.0, -15.0, -np.pi / 2),
        human_start_mask=_sce3_dataset_start,
        human_end_mask=_sce3_human_end,
        n_background_vehicles=2,
        human_trim_mode="first_index",
        human_trim_mask=lambda traj: traj[:, 1] <= 40,
        grid_x=(148, 158),
        grid_y=(-80, 22),
        plot_xlim=(80, 230),
        plot_ylim=(-100, 50),
        lane_lines=(
            LaneLine("x", 153.3, "solid", (-100, 60)),
            LaneLine("x", 156.8, "solid", (-100, 60)),
            LaneLine("x", 149.7, "solid", (-100, 60)),
        ),
        axis_flip="y",
        thw_distance=80.0,
        thw_distance_by_suffix=None,
        sut_jerk_axis="ay",
        dnda=DndaConfig(
            lane_num=1, lane_egodirect=1, baseline_fn=_baseline_sce3,
            bike_svs=(1,), stop_fn=_dnda_stop_sce3,
        ),
        sut_episode_start=_sce3_sut_start,
        sut_episode_end=_sce3_sut_end,
        bv1_plot_size=(2.5, 1.5),  # sce3's first background vehicle is a bicycle
        lateral_offset_center=("x", 155.05),
        published_best={
            "velocity_js_divergence": 0.127377,
            "rmse_frequency_trajcount": 6.838131,
            "surface_rmse_with_zeros": 2.89808723,
            "surface_rmse_no_zeros": 3.28143761,
        },
    ),
    "sce4": Scenario(
        key="sce4",
        town="UnpredictableMovementTown04",
        index=4,
        dt=0.02,
        dataset_start=_sce4_dataset_start,
        # & (not `and`) so the predicate vectorizes: process_csv applies it
        # to the whole tail Frame as well as to single rows
        dataset_end_row=lambda row: (row["sv1_x"] > 15) & (row["sv1_yaw"] < -85),
        start_condition_mask=_sce4_dataset_start,
        start_fallback=(11.0, 0.0, -np.pi / 2),
        human_start_mask=_sce4_human_start,
        human_end_mask=_sce4_human_end,
        n_background_vehicles=1,
        human_trim_mode="first_index",
        human_trim_mask=lambda traj: traj[:, 0] < 9,
        grid_x=(0, 20),
        grid_y=(-20, 100),
        plot_xlim=(-45, 65),
        plot_ylim=(-10, 100),
        lane_lines=(
            LaneLine("x", 3.5, "solid", (-40, 120)),
            LaneLine("x", 7.0, "dashed", (-40, 120)),
            LaneLine("x", 10.5, "dashed", (-40, 120)),
            LaneLine("x", 14.0, "dashed", (-40, 120)),
            LaneLine("x", 17.5, "solid", (-40, 120)),
        ),
        axis_flip="y",
        thw_distance=None,
        thw_distance_by_suffix={"3": 40.0, "default": 30.0},
        sut_jerk_axis="ay",
        dnda=DndaConfig(
            lane_num=3, lane_egodirect=3, baseline_fn=_baseline_sce4,
            stop_fn=_dnda_stop_sce4,
        ),
        sut_episode_start=_sce4_sut_start,
        sut_episode_end=_sce4_sut_end,
        lateral_offset_center=("x", 16.25),
        provenance_notes=(
            "sce4 corpus is n=134: the 135th shipped window is stale "
            "(not derivable from any raw CSV); see tests/test_data.py",
        ),
        published_best={
            "velocity_js_divergence": 0.041909,
            "rmse_frequency_trajcount": 9.168905,
            "surface_rmse_with_zeros": 3.89329095,
            "surface_rmse_no_zeros": 4.17855121,
        },
    ),
}

TOWN_TO_KEY = {s.town: s.key for s in REGISTRY.values()}

# Maneuver subfolders in the raw dataset (reference Traj_Data_Process.py:28;
# Distribution.collect_csv_files iterates THIS order — :34)
ACTIONS = ("减速", "减速+转向", "转向")

# The order the shipped npy DATASETS were actually generated with: the
# reference's dataset __main__ overrides ACTIONS (Traj_Data_Process.py:162).
# With lexicographically sorted per-folder files, this order reproduces
# every shipped trajectory_sce*_cond.npy row-for-row byte-exactly
# (tests/test_data.py::test_window_extraction_exact_parity).
DATASET_ACTIONS = ("减速", "转向", "减速+转向")

_SCE_RE = re.compile(r"sce([1-4])")


def get(key_or_name: str) -> Scenario:
    """Resolve a scenario from a key ('sce3'), a town name, or any string
    containing a scenario key (the reference's model-filename convention)."""
    if key_or_name in REGISTRY:
        return REGISTRY[key_or_name]
    if key_or_name in TOWN_TO_KEY:
        return REGISTRY[TOWN_TO_KEY[key_or_name]]
    m = _SCE_RE.search(key_or_name)
    if m:
        return REGISTRY["sce" + m.group(1)]
    # reference falls through to sce3 behavior for unknown names
    # (Tools.py:91-97 else-branch); we are stricter and raise.
    raise KeyError(f"unknown scenario: {key_or_name!r}")


def keys() -> Sequence[str]:
    return tuple(REGISTRY.keys())
