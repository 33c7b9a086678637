"""Physical constants and default capacities.

JAX rebuild of the constants in the MPTRAC reference
(/root/reference/src/mptrac.h:250-424).  Values are the standard
physical constants used by the reference so that numerical output is
comparable; they are plain Python floats (static at trace time).
"""

import math

# --- Physical constants (reference mptrac.h:250-325) ---

#: Avogadro constant [1/mol]
AVO = 6.02214076e23
#: Specific heat of dry air at constant pressure [J/(kg K)]
CPD = 1003.5
#: Standard gravity [m/s^2]
G0 = 9.80665
#: Scale height [km]
H0 = 7.0
#: Latent heat of vaporization of water [J/kg]
LV = 2501000.0
#: Karman constant [1]
KARMAN = 0.40
#: Boltzmann constant [kg m^2/(K s^2)]
KB = 1.3806504e-23
#: Molar mass of dry air [g/mol]
MA = 28.9644
#: Molar mass of water vapor [g/mol]
MH2O = 18.01528
#: Molar mass of ozone [g/mol]
MO3 = 48.00
#: Standard pressure [hPa]
P0 = 1013.25
#: Ideal gas constant [J/(mol K)]
RI = 8.3144598
#: Specific gas constant of dry air [J/(kg K)]
RA = 1e3 * RI / MA
#: Mean radius of Earth [km]
RE = 6367.421
#: Standard temperature [K]
T0 = 273.15
#: Ratio of specific gas constants of dry air and water vapor [1]
EPS = MH2O / MA

#: Degrees-to-radians factor
DEG2RAD_F = math.pi / 180.0
RAD2DEG_F = 180.0 / math.pi

# --- Default capacities (static shapes; reference mptrac.h:334-424) ---
# Unlike the reference these are not compile-time constants of the build:
# every array carries its own shape.  They are provided as defaults for
# tools and tests.

#: Default max number of pressure levels for meteo data
EP = 140
#: Default max number of longitudes for meteo data
EX = 1444
#: Default max number of latitudes for meteo data
EY = 724
#: Default max number of particles
NP = 10000000
#: Default max number of quantities
NQ = 15
#: Default max number of ensembles
NENS = 2000
