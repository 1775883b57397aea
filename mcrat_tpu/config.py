"""Runtime configuration for mcrat_tpu.

The reference configures all physics/geometry switches at *compile time* through
preprocessor macros in Src/mcrat_input.h, validated by Src/mcrat.h:262-428, plus a
small runtime parameter file mc.par (parsed at Src/mcrat_io.c:1136-1237).  This
framework replaces the whole two-tier system with one typed runtime config:
changing physics never requires recompilation; jit specializes on the static
fields automatically.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class HydroSim(enum.Enum):
    """Hydro input format (reference: SIM_SWITCH, Src/mcrat.h:17-20)."""

    FLASH = "flash"
    PLUTO_CHOMBO = "pluto_chombo"
    PLUTO = "pluto"
    RIKEN = "riken"
    SYNTHETIC = "synthetic"  # new: analytic grid with no data files at all


class PlutoFileType(enum.Enum):
    """PLUTO on-disk file types (reference: Src/mcrat.h:23-27)."""

    DBL = "dbl"
    FLT = "flt"
    DBL_H5 = "dbl.h5"
    FLT_H5 = "flt.h5"
    VTK = "vtk"


class SimType(enum.Enum):
    """Test-problem overwrites (reference: SIMULATION_TYPE, Src/mcrat.h:30-33)."""

    SCIENCE = "science"
    CYLINDRICAL_OUTFLOW = "cylindrical_outflow"
    SPHERICAL_OUTFLOW = "spherical_outflow"
    STRUCTURED_SPHERICAL_OUTFLOW = "structured_spherical_outflow"


class Geometry(enum.Enum):
    """Hydro grid geometry (reference: GEOMETRY, Src/mcrat.h:36-39)."""

    CARTESIAN = "cartesian"
    SPHERICAL = "spherical"
    CYLINDRICAL = "cylindrical"
    POLAR = "polar"  # 3-D only


class Dims(enum.Enum):
    """Hydro dimensionality (reference: DIMENSIONS, Src/mcrat.h:42-44)."""

    TWO = 2
    TWO_POINT_FIVE = 25
    THREE = 3

    @property
    def is_3d(self) -> bool:
        return self is Dims.THREE

    @property
    def ncoord(self) -> int:
        """Number of stored grid coordinates (2.5-D stores 2 coords + 3 vectors)."""
        return 3 if self is Dims.THREE else 2


class BFieldCalc(enum.Enum):
    """Magnetic-field model (reference: B_FIELD_CALC, Src/mcrat.h:47-49)."""

    INTERNAL_E = "internal_e"
    TOTAL_E = "total_e"
    SIMULATION = "simulation"


class TauCalculation(enum.Enum):
    """Optical-depth cross-section mode (reference: Src/mcrat.h:64-65)."""

    DIRECT = "direct"  # Thomson cross section in the tau-rate
    TABLE = "table"  # pretabulated "hot" energy/temperature-dependent sigma


class NonthermalDist(enum.Enum):
    """Non-thermal electron distribution (reference: Src/mcrat.h:60-61)."""

    OFF = "off"
    POWERLAW = "powerlaw"
    BROKENPOWERLAW = "brokenpowerlaw"


class Spectrum(enum.Enum):
    """Injection spectrum (reference: mc.par 'spect' char, Src/mclib.c:20-29)."""

    BLACKBODY = "b"
    WIEN = "w"


# Photon type codes (reference: Src/mcrat.h:52-57). Stored as small ints in the
# device photon arrays; the single-char codes are kept for the on-disk schema.
class PhotonType(enum.IntEnum):
    INJECTED = 0  # 'i'
    COMPTONIZED = 1  # 'k'
    CS_POOL = 2  # 'p'
    UNABSORBED_CS = 3  # 'c'
    REBINNED = 4  # 'r'
    NULL = 5  # 'N'


PHOTON_TYPE_CHARS = {
    PhotonType.INJECTED: "i",
    PhotonType.COMPTONIZED: "k",
    PhotonType.CS_POOL: "p",
    PhotonType.UNABSORBED_CS: "c",
    PhotonType.REBINNED: "r",
    PhotonType.NULL: "N",
}
PHOTON_CHAR_TYPES = {v: k for k, v in PHOTON_TYPE_CHARS.items()}


@dataclasses.dataclass(frozen=True)
class Config:
    """Static simulation configuration.

    Mirrors the reference's compile-time macro surface (Src/mcrat_input.h and the
    validation/default logic in Src/mcrat.h:262-428) as one frozen dataclass.
    Hashable so it can be closed over by jitted functions as a static argument.
    """

    # --- geometry / hydro format -------------------------------------------------
    sim_switch: HydroSim = HydroSim.SYNTHETIC
    geometry: Geometry = Geometry.SPHERICAL
    dims: Dims = Dims.TWO
    simulation_type: SimType = SimType.SCIENCE
    pluto_filetype: PlutoFileType = PlutoFileType.DBL

    # --- unit scales (reference: HYDRO_*_SCALE, Src/mcrat.h:287-293) --------------
    hydro_l_scale: float = 1.0
    hydro_d_scale: float = 1.0
    hydro_v_scale: float = 2.99792458e10  # HYDRO_V_SCALE == C_LIGHT

    # --- physics switches ---------------------------------------------------------
    stokes: bool = True  # STOKES_SWITCH
    comv: bool = True  # COMV_SWITCH (save comoving four-momenta)
    save_type: bool = True  # SAVE_TYPE (save photon type chars)
    tau_calculation: TauCalculation = TauCalculation.DIRECT
    cyclosynchrotron: bool = False  # CYCLOSYNCHROTRON_SWITCH
    b_field_calc: BFieldCalc = BFieldCalc.TOTAL_E
    epsilon_b: float = 0.5

    # cyclo-synchrotron rebinning (reference: Src/mcrat.h:307-322)
    cs_rebin_e_perc: float = 0.1  # CYCLOSYNCHROTRON_REBIN_E_PERC
    cs_rebin_ang: float = 0.5  # CYCLOSYNCHROTRON_REBIN_ANG [deg]
    cs_rebin_ang_phi: float = 10.0  # CYCLOSYNCHROTRON_REBIN_ANG_PHI [deg]

    # --- nonthermal electrons (reference: Src/mcrat.h:340-388) --------------------
    nonthermal_e_dist: NonthermalDist = NonthermalDist.OFF
    powerlaw_index: Optional[float] = None  # POWERLAW_INDEX
    powerlaw_index_1: Optional[float] = None  # POWERLAW_INDEX_1
    powerlaw_index_2: Optional[float] = None  # POWERLAW_INDEX_2
    gamma_break: Optional[float] = None  # GAMMA_BREAK
    gamma_min: Optional[float] = None  # GAMMA_MIN
    gamma_max: Optional[float] = None  # GAMMA_MAX
    n_gamma: int = 3  # N_GAMMA subgroups (reference: Src/hot_x_section.h:17)

    # --- numerics (new; no reference equivalent) ----------------------------------
    # float32 is the accelerator fast path; float64 is for CPU validation runs.
    dtype: str = "float32"
    # Max scatter rounds per frame inside the batched transport while_loop; purely a
    # safety bound (a photon deep in the jet scatters ~tau^2 times per frame).
    max_rounds_per_frame: int = 2_000_000
    # Capacity factor for the fixed-size photon arrays (capacity = factor * n_inject).
    capacity_factor: float = 1.5

    def __post_init__(self):
        # Cross-constraint validation, mirroring Src/mcrat.h:269-427.
        if self.nonthermal_e_dist is not NonthermalDist.OFF:
            if self.tau_calculation is TauCalculation.DIRECT:
                raise ValueError(
                    "nonthermal_e_dist cannot be set while tau_calculation=DIRECT "
                    "(reference: Src/mcrat.h:276-278)"
                )
            if self.gamma_min is None or self.gamma_max is None:
                raise ValueError("gamma_min/gamma_max required with nonthermal electrons")
            if self.nonthermal_e_dist is NonthermalDist.POWERLAW and self.powerlaw_index is None:
                raise ValueError("powerlaw_index required for POWERLAW distribution")
            if self.nonthermal_e_dist is NonthermalDist.BROKENPOWERLAW:
                if None in (self.powerlaw_index_1, self.powerlaw_index_2, self.gamma_break):
                    raise ValueError(
                        "powerlaw_index_1/2 and gamma_break required for BROKENPOWERLAW"
                    )
        if self.geometry is Geometry.POLAR and self.dims is not Dims.THREE:
            raise ValueError("POLAR geometry is 3-D only (reference: Src/mcrat.h:39)")
        if self.geometry is Geometry.CYLINDRICAL and self.dims is Dims.THREE:
            raise ValueError("CYLINDRICAL geometry is 2-D only; use POLAR in 3-D")

    # Derived unit scales (reference: Src/mcrat.h:290-293)
    @property
    def hydro_p_scale(self) -> float:
        return self.hydro_d_scale * self.hydro_v_scale * self.hydro_v_scale

    @property
    def hydro_b_scale(self) -> float:
        import math

        return math.sqrt(4.0 * math.pi * self.hydro_p_scale)

    def np_dtype(self):
        import numpy as np

        return np.dtype(self.dtype)


@dataclasses.dataclass
class McPar:
    """Runtime parameters: the mc.par file (reference: Src/mcrat_io.c:1136-1237).

    Angle-bin arrays have one entry per injection-angle bin, matching the per-bin
    columns in the reference format (see sample_mc.par and Doc/mcrat_doc.tex:140-211).
    """

    fps: float
    last_frame: int
    r0_domain: Tuple[float, float]
    r1_domain: Tuple[float, float]
    r2_domain: Tuple[float, float]
    theta_min_deg: float
    theta_max_deg: float
    n_theta_bins: int
    frm0: Tuple[int, ...]  # injection start frame per angle bin
    frm2: Tuple[int, ...]  # injection end frame per angle bin (frm0 + n_inject)
    inj_radius: Tuple[float, ...]  # injection radius per angle bin
    spect: Spectrum
    min_photons: int
    max_photons: int
    restart: str  # 'i' initialize | 'c' continue
