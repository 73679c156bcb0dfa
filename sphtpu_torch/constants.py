"""Physical constants (CGS), matching the reference values exactly.

Reference: julia_version/fastv1_kd&single_oc/iniconds.jl:532-533,545,572-573.
"""

# Gravitational constant [cm^3 g^-1 s^-2] (iniconds.jl:545)
G_CGS = 6.67430e-8

# Parsec in [cm] (iniconds.jl:532)
R0_PC = 5.38552341e16

# Solar mass in [g] (iniconds.jl:533)
M0_SUN = 1.9891e33

# Boltzmann constant [erg K^-1] (iniconds.jl:572)
KB = 1.380649e-16

# Mass of hydrogen atom [g] (iniconds.jl:573)
MH = 1.6735575e-24
