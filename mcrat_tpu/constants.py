"""Physical constants in cgs units.

Values match the reference MCRaT globals (reference: Src/mclib.c:4-5) so that
spectra/weights computed by this framework are bit-comparable with the C code.
"""

# Radiation constant [erg cm^-3 K^-4]
A_RAD = 7.56e-15
# Speed of light [cm/s]
C_LIGHT = 2.99792458e10
# Planck constant [erg s]
PL_CONST = 6.6260755e-27
# Fine-structure constant
FINE_STRUCT = 7.29735308e-3
# Electron charge [esu]
CHARGE_EL = 4.8032068e-10
# Boltzmann constant [erg/K]
K_B = 1.380658e-16
# Proton mass [g]
M_P = 1.6726231e-24
# Thomson cross section [cm^2]
THOM_X_SECT = 6.65246e-25
# Electron mass [g]
M_EL = 9.1093879e-28
# Classical electron radius [cm]
R_EL = 2.817941499892705e-13

# Derived conveniences (reference: Src/mcrat.h:79-81)
# erg -> keV conversion for an E/c four-momentum component: p0 * C_LIGHT / 1.6e-9
ERG_TO_KEV = 1.0 / 1.6e-9

# Electron rest-mass momentum scale m_e * c [g cm/s]. Photon four-momenta in this
# framework are stored dimensionless, normalized by this scale, which keeps the
# dynamic range friendly to float32 (p0_hat = h nu / (m_e c^2)).
ME_C = M_EL * C_LIGHT
# Electron rest energy [erg]
ME_C2 = M_EL * C_LIGHT * C_LIGHT

# k_B T / (m_e c^2) for T in Kelvin: dimensionless electron temperature theta.
KB_OVER_MEC2 = K_B / ME_C2

# h / (m_e c^2): converts frequency [Hz] to dimensionless photon energy.
H_OVER_MEC2 = PL_CONST / ME_C2
