"""Detector geometry and photometric constants for the Roman WFI H4RG SCAs.

The constants layer of ``romanimpreprocess`` (reference:
``src/romanimpreprocess/pars.py:8-21``), kept as a copy so this package
imports nothing from the JAX package.
"""

# Detector array parameters
nside = 4096  # full SCA side, pixels
nborder = 4  # reference-pixel border width
nchannel = 32  # readout channels

# Derived geometry
nside_active = nside - 2 * nborder  # 4088: science pixels
channelwidth = nside // nchannel  # 128: columns per readout channel
nside_augmented = nside + channelwidth  # 4224: SCA + amp33 reference output

# Photometric normalization (see reference LaTeX conventions doc)
Omega_ideal = 2.8440360952308436e-13  # (0.11 arcsec)^2 in steradians
h_Planck = 6.62607015e-24  # J s (exact)
g_ideal = 1.458  # e/DN zero-point gain for flattened digital numbers

# Timing default (seconds per frame read); MA tables may override.
read_time = 3.04
