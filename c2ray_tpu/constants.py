"""Physical constants and conversion factors (cgs units).

Re-implementation of the constant layer of C2-Ray
(reference: /root/reference/cgsconstants.f90, cgsphotoconstants.f90,
cgsastroconstants.f90:14-35, mathconstants.f90, abundances.f90:23-32,
atomic.f90:23-25).  These are plain Python floats used both host-side
(table building, config derivation) and inside jitted kernels (where they
fold into the compiled graph as literals at the working dtype).
"""

from __future__ import annotations

import math

# ---------------------------------------------------------------------------
# math constants (mathconstants.f90)
# ---------------------------------------------------------------------------
PI = math.pi

# ---------------------------------------------------------------------------
# fundamental constants (cgsconstants.f90:26-43)
# ---------------------------------------------------------------------------
M_P = 1.672661e-24          # proton mass [g]
C_LIGHT = 2.997925e10       # speed of light [cm/s]
HPLANCK = 6.6260755e-27     # Planck constant [erg s]
SIGMA_SB = 5.670e-5         # Stefan-Boltzmann constant
K_B = 1.381e-16             # Boltzmann constant [erg/K]
G_GRAV = 6.6732e-8          # gravitational constant

EV2K = 1.0 / 8.617e-05      # eV -> K
EV2ERG = 1.602e-12          # eV -> erg
EV2FR = 0.241838e15         # eV -> Hz (cgsconstants.f90:53)

TWO_PI_OVER_C_SQUARE = 2.0 * PI / (C_LIGHT * C_LIGHT)  # cgsconstants.f90:61

# ---------------------------------------------------------------------------
# hydrogen atomic data (cgsconstants.f90:63-88)
# ---------------------------------------------------------------------------
ALBPOW = -0.7               # case-B recombination power-law index
BH00 = 2.59e-13             # case-B recombination coefficient at 1e4 K
ETH0 = 13.598               # H ionization energy [eV]
HIONEN = ETH0 * EV2ERG      # H ionization energy [erg]
TEMPH0 = ETH0 * EV2K        # H ionization energy [K]
XIH0 = 1.0
FH0 = 0.83
COLH0 = 1.3e-8 * FH0 * XIH0 / (ETH0 * ETH0)  # collisional ionization coeff

# ---------------------------------------------------------------------------
# photo constants (cgsphotoconstants.f90:24-35)
# ---------------------------------------------------------------------------
SIGMA_HI_AT_ION_FREQ = 6.30e-18     # HI cross-section at threshold [cm^2]
ION_FREQ_HI = EV2FR * ETH0          # HI ionization threshold [Hz]
ETHE = (24.587, 54.416)             # He ionization energies [eV]
ION_FREQ_HEI = EV2FR * ETHE[0]
ION_FREQ_HEII = EV2FR * ETHE[1]

# ---------------------------------------------------------------------------
# astro constants (cgsastroconstants.f90:23-33)
# ---------------------------------------------------------------------------
R_SOLAR = 6.9599e10
L_SOLAR = 3.826e33
M_SOLAR = 1.98892e33
YEAR = 3.15576e7
PC = 3.086e18
KPC = 1e3 * PC
MPC = 1e6 * PC

# ---------------------------------------------------------------------------
# abundances (abundances.f90:23-32)
# ---------------------------------------------------------------------------
ABU_HE = 0.074                      # helium abundance by number
ABU_C = 7.1e-7                      # carbon abundance by number
ABU_H = 1.0 - ABU_HE
MU = (1.0 - ABU_HE) + 4.0 * ABU_HE  # mean molecular weight

# ---------------------------------------------------------------------------
# atomic / thermodynamics (atomic.f90:23-25)
# ---------------------------------------------------------------------------
GAMMA = 5.0 / 3.0
GAMMA1 = GAMMA - 1.0


def hui_gnedin_brech0(temperature: float) -> float:
    """Case-B H recombination coefficient, Hui & Gnedin (1997) fit.

    Reference: cgsconstants.f90:155-173 (ini_hydrogen_recombination).
    Works on scalars and arrays (numpy/jax) alike.
    """
    lam = 2.0 * (TEMPH0 / temperature)
    return 2.753e-14 * lam**1.5 / (1.0 + (lam / 2.740) ** 0.407) ** 2.242


def hui_gnedin_arech0(temperature: float) -> float:
    """Case-A H recombination coefficient, Hui & Gnedin (1997) fit.

    Reference: cgsconstants.f90:169-171.
    """
    lam = 2.0 * (TEMPH0 / temperature)
    return 1.269e-13 * lam**1.503 / (1.0 + (lam / 0.522) ** 0.470) ** 1.923


def colli_hi(temperature):
    """Collisional ionization coefficient for HI (Cox 1970 fit).

    Reference: cgsconstants.f90:250-252.
    """
    import numpy as np

    sqrtt0 = np.sqrt(temperature)
    return COLH0 * sqrtt0 * np.exp(-TEMPH0 / temperature)
