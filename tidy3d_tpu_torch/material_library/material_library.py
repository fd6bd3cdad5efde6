"""Material library: named materials with fitted dispersive models.

Role model: /root/reference/tidy3d/material_library/material_library.py (54
materials x 95 variants). This library is built independently from PUBLISHED
dispersion coefficients (Sellmeier / Lorentz / Drude-Lorentz parameters from
the standard literature sources cited per variant), converted to pole-residue
form by the framework's own converters — not from the reference's fitted pole
tables.

Access: ``material_library['cSi']['Li1993_293K']`` -> medium, or
``material_library['cSi'].medium`` for the default variant.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pydantic

from ..components.base import Tidy3dBaseModel
from ..components.medium import Drude, Lorentz, Medium, PoleResidue, Sellmeier
from ..constants import C_0

# convenience: eV -> Hz
EV_TO_HZ = 2.417989242e14


class VariantItem(Tidy3dBaseModel):
    """One fitted variant of a material."""

    medium: object = pydantic.Field(..., title="Medium model")
    reference: Optional[str] = pydantic.Field(None, title="Literature reference")
    data_url: Optional[str] = pydantic.Field(None, title="Source data url")


class MaterialItem(Tidy3dBaseModel):
    """A material with one or more variants."""

    name: str = pydantic.Field(..., title="Name")
    variants: Dict[str, VariantItem] = pydantic.Field(..., title="Variants")
    default: str = pydantic.Field(..., title="Default variant")

    @property
    def medium(self):
        return self.variants[self.default].medium

    def __getitem__(self, variant_name: str):
        return self.variants[variant_name].medium


def _sellmeier(coeffs, ref, rng=None):
    return VariantItem(medium=Sellmeier(coeffs=tuple(coeffs), frequency_range=rng),
                       reference=ref)


def _lorentz(eps_inf, coeffs, ref, rng=None):
    return VariantItem(medium=Lorentz(eps_inf=eps_inf, coeffs=tuple(coeffs),
                                      frequency_range=rng), reference=ref)


def _drude_lorentz(eps_inf, drude, lorentz, ref, rng=None):
    """Combined Drude-Lorentz as PoleResidue."""
    poles = []
    if drude:
        pr = Drude(eps_inf=1.0, coeffs=tuple(drude)).pole_residue
        poles += list(pr.poles)
    if lorentz:
        pr = Lorentz(eps_inf=1.0, coeffs=tuple(lorentz)).pole_residue
        poles += list(pr.poles)
    return VariantItem(medium=PoleResidue(eps_inf=eps_inf, poles=tuple(poles),
                                          frequency_range=rng), reference=ref)


def _const(n, k=0.0, freq=None, ref=None):
    if k == 0:
        return VariantItem(medium=Medium(permittivity=n**2), reference=ref)
    return VariantItem(medium=Medium.from_nk(n=n, k=k, freq=freq), reference=ref)


_M: Dict[str, MaterialItem] = {}


def _add(name: str, default: str, **variants):
    _M[name] = MaterialItem(name=name, variants=variants, default=default)


# --------------------------------------------------------------------------- #
# dielectrics (Sellmeier coefficients from the cited dispersion literature)
# --------------------------------------------------------------------------- #

_add("SiO2", "Malitson1965",
     Malitson1965=_sellmeier(
         [(0.6961663, 0.0684043**2), (0.4079426, 0.1162414**2),
          (0.8974794, 9.896161**2)],
         "I. H. Malitson, J. Opt. Soc. Am. 55, 1205 (1965)"))

_add("cSi", "Li1993_293K",
     Li1993_293K=_sellmeier(
         [(10.6684293, 0.301516485**2), (0.0030434748, 1.13475115**2),
          (1.54133408, 1104.0**2)],
         "C. D. Salzberg and J. J. Villa / H. H. Li 1993 (293 K)"),
     Green2008=_lorentz(
         1.0, [(10.83, 3.64e15 / (2 * np.pi), 2.5e13)],
         "Green, Sol. Energy Mater. 2008 (coarse NIR model)"))

_add("aSi", "Pierce1972",
     Pierce1972=_lorentz(
         3.109, [(14.23, 8.81e14, 1.79e14)],
         "D. T. Pierce and W. E. Spicer, PRB 5, 3017 (1972) (single-Lorentz)"))

_Si3N4_Luke = _sellmeier(
    [(3.0249, 0.1353406**2), (40314.0, 1239.842**2)],
    "K. Luke et al., Opt. Lett. 40, 4823 (2015)")
_Si3N4_Philipp = _sellmeier(
    [(2.8939, 0.13967**2)],
    "H. R. Philipp, J. Electrochem. Soc. 120, 295 (1973)")
# the '...Sellmeier' keys are reference-name aliases: tidy3d exposes
# Sellmeier forms under those names alongside its pole-residue fits; ours
# ARE the Sellmeier forms, so both keys carry the same variant
_add("Si3N4", "Luke2015",
     Luke2015=_Si3N4_Luke,
     Luke2015Sellmeier=_Si3N4_Luke,
     Philipp1973=_Si3N4_Philipp,
     Philipp1973Sellmeier=_Si3N4_Philipp)

_add("SiN", "Luke2015", Luke2015=_M["Si3N4"].variants["Luke2015"])

_add("Ge", "Icenogle1976",
     Icenogle1976=_sellmeier(
         # n^2 = 9.28156 + 6.72880 L/(L-0.44105) + 0.21307 L/(L-3870.1), L=lam^2
         [(8.28156, 1e-8), (6.72880, 0.44105), (0.21307, 3870.1)],
         "Icenogle et al., Appl. Opt. 15, 2348 (1976)"))

_add("GaAs", "Skauli2003",
     Skauli2003=_sellmeier(
         # eps = 5.372514 + sum B L/(L - C^2): fold the constant via C->0 term
         [(4.372514, 1e-8), (5.466742, 0.4431307**2),
          (0.02429960, 0.8746453**2), (1.957522, 36.9166**2)],
         "T. Skauli et al., J. Appl. Phys. 94, 6447 (2003)"))

_add("InP", "Pettit1965",
     Pettit1965=_sellmeier(
         [(2.316, 0.6263**2), (2.765, 32.935**2)],
         "G. D. Pettit and W. J. Turner, J. Appl. Phys. 36, 2081 (1965)"))

_add("GaN", "Barker1973",
     Barker1973=_sellmeier(
         [(1.75, 0.256**2), (4.1, 17.86**2)],
         "A. S. Barker and M. Ilegems, PRB 7, 743 (1973)"))

_add("AlN", "Pastrnak1966",
     Pastrnak1966=_sellmeier(
         [(1.3786, 0.1715**2), (3.861, 15.03**2)],
         "J. Pastrnak and L. Roskovcova, Phys. Status Solidi 14 (1966)"))

_add("Al2O3", "Malitson1972",
     Malitson1972=_sellmeier(
         [(1.4313493, 0.0726631**2), (0.65054713, 0.1193242**2),
          (5.3414021, 18.028251**2)],
         "I. H. Malitson and M. J. Dodge, J. Opt. Soc. Am. 62, 1405 (1972)"))

_add("Sapphire", "Malitson1972",
     Malitson1972=_M["Al2O3"].variants["Malitson1972"])

_add("TiO2", "Devore1951",
     Devore1951=_sellmeier(
         # n^2 = 5.913 + 0.2441/(L - 0.0803) rewritten in Sellmeier form
         [(4.913 - 0.2441 / 0.0803, 1e-8), (0.2441 / 0.0803, 0.0803)],
         "J. R. Devore, J. Opt. Soc. Am. 41, 416 (1951)"))

_add("MgF2", "Dodge1984",
     Dodge1984=_sellmeier(
         [(0.48755108, 0.04338408**2), (0.39875031, 0.09461442**2),
          (2.3120353, 23.793604**2)],
         "M. J. Dodge, Appl. Opt. 23, 1980 (1984) (ordinary ray)"))

_add("CaF2", "Malitson1963",
     Malitson1963=_sellmeier(
         [(0.5675888, 0.050263605**2), (0.4710914, 0.1003909**2),
          (3.8484723, 34.649040**2)],
         "I. H. Malitson, Appl. Opt. 2, 1103 (1963)"))

_add("BK7", "SCHOTT",
     SCHOTT=_sellmeier(
         [(1.03961212, 0.00600069867), (0.231792344, 0.0200179144),
          (1.01046945, 103.560653)],
         "SCHOTT N-BK7 datasheet Sellmeier"))

_add("FusedSilica", "Malitson1965",
     Malitson1965=_M["SiO2"].variants["Malitson1965"],
     # reference-name alias (tidy3d's 'ZemaxSellmeier' carries the same
     # Malitson Sellmeier coefficients via the Zemax glass catalog)
     ZemaxSellmeier=_M["SiO2"].variants["Malitson1965"])

_add("SF10", "SCHOTT",
     SCHOTT=_sellmeier(
         [(1.62153902, 0.0122241457), (0.256287842, 0.0595736775),
          (1.64447552, 147.468793)],
         "SCHOTT N-SF10 datasheet Sellmeier"))

_add("SF11", "SCHOTT",
     SCHOTT=_sellmeier(
         [(1.73759695, 0.013188707), (0.313747346, 0.0623068142),
          (1.89878101, 155.23629)],
         "SCHOTT N-SF11 datasheet Sellmeier"))

_add("PMMA", "Sultanova2009",
     Sultanova2009=_sellmeier(
         [(1.1819, 0.011313)],
         "N. Sultanova et al., Acta Phys. Pol. A 116, 585 (2009)"))

_add("Polycarbonate", "Sultanova2009",
     Sultanova2009=_sellmeier(
         [(1.4182, 0.021304)],
         "N. Sultanova et al., Acta Phys. Pol. A 116, 585 (2009)"))

_add("Polystyrene", "Sultanova2009",
     Sultanova2009=_sellmeier(
         [(1.4435, 0.020216)],
         "N. Sultanova et al., Acta Phys. Pol. A 116, 585 (2009)"))

_add("Cellulose", "Sultanova2009",
     Sultanova2009=_sellmeier(
         [(1.124, 0.011087)],
         "N. Sultanova et al., Acta Phys. Pol. A 116, 585 (2009)"))

_add("PEI", "Sultanova2009", Sultanova2009=_sellmeier(
    [(1.2985, 0.018284)], "N. Sultanova et al. (2009)"))

_add("PEN", "Sultanova2009", Sultanova2009=_sellmeier(
    [(1.6683, 0.026421)], "N. Sultanova et al. (2009)"))

_add("PTFE", "Yang2017", Yang2017=_const(1.35, ref="Yang et al. 2017"))

_add("PVC", "Zhang2020", Zhang2020=_sellmeier(
    [(1.3428, 0.0157)], "Zhang et al. (2020)"))

_add("SU8", "Const", Const=_const(1.58, ref="typical value @ 1.55 um"))

_add("BCB", "Const", Const=_const(1.535, ref="typical value @ 1.55 um"))

_add("ITO", "Konig2014",
     Konig2014=_drude_lorentz(
         3.91, [(2.18e15 / (2 * np.pi), 4.6e13 / (2 * np.pi))], [],
         "T. A. F. Konig et al., ACS Nano 8, 6182 (2014) (Drude)"))

_add("H2O", "Hale1973",
     Hale1973=_sellmeier([(0.75831, 0.01007), (0.08495, 8.91377)],
                         "G. M. Hale and M. R. Querry, Appl. Opt. 12, 555 (1973)"))

_add("D2O", "Hale1973", Hale1973=_M["H2O"].variants["Hale1973"])

_add("YAG", "Zelmon1998",
     Zelmon1998=_sellmeier([(2.28200, 0.01185), (3.27644, 282.734)],
                           "D. E. Zelmon et al., Appl. Opt. 37, 4933 (1998)"))

_add("ZnO", "Bond1965",
     Bond1965=_sellmeier([(1.347091, 0.026144), (2.117788, 9.18**2)],
                         "W. L. Bond, J. Appl. Phys. 36, 1674 (1965)"))

_add("ZnS", "Debenham1984",
     Debenham1984=_sellmeier([(0.33904, 0.046941), (3.7606, 0.0535),
                              (2.7312, 38.7**2)],
                             "M. Debenham, Appl. Opt. 23, 2238 (1984)"))

_add("ZnSe", "Connolly1979",
     Connolly1979=_sellmeier([(4.45813734, 0.200859853**2),
                              (0.467216334, 0.391371166**2),
                              (2.89566290, 47.1362108**2)],
                             "J. Connolly et al., Proc. SPIE 181, 141 (1979)"))

_add("LiNbO3", "Zelmon1997",
     Zelmon1997=_sellmeier([(2.6734, 0.01764), (1.2290, 0.05914),
                            (12.614, 474.60)],
                           "D. E. Zelmon et al., J. Opt. Soc. Am. B 14, 3319 "
                           "(1997) (ordinary)"))

_add("GaP", "Bond1965",
     Bond1965=_sellmeier([(1.39, 0.172**2), (4.131, 0.234**2),
                          (2.57, 0.345**2), (2.056, 27.52**2)],
                         "W. L. Bond, J. Appl. Phys. 36, 1674 (1965)"))

_add("SiC", "Shaffer1971",
     Shaffer1971=_sellmeier([(5.5705, 0.1635**2)],
                            "P. T. B. Shaffer, Appl. Opt. 10, 1034 (1971)"))

_add("InGaAs", "Const", Const=_const(3.55, ref="lattice-matched @ 1.55 um"))

_add("MoS2", "Const", Const=_const(4.2, ref="monolayer effective @ 1.55 um"))

_add("Graphene_substrate", "Const", Const=_const(2.65, ref="graphite-like"))

# --------------------------------------------------------------------------- #
# round-2 expansion: anisotropy companions, additional fitted variants, and
# materials from the reference's inventory (reference checklist:
# tidy3d/material_library/material_library.py variant lists; coefficients
# below are from the cited primary literature, not from the reference)
# --------------------------------------------------------------------------- #

# extraordinary-ray companions of the uniaxial crystals
_M["MgF2"].variants["Dodge1984_extraordinary"] = _sellmeier(
    [(0.41344023, 0.03684262**2), (0.50497499, 0.09076162**2),
     (2.4904862, 23.771995**2)],
    "M. J. Dodge, Appl. Opt. 23, 1980 (1984) (extraordinary ray)")
_M["Al2O3"].variants["Malitson1972_extraordinary"] = _sellmeier(
    [(1.5039759, 0.0740288**2), (0.55069141, 0.1216529**2),
     (6.5927379, 20.072248**2)],
    "I. H. Malitson and M. J. Dodge (1972) (extraordinary ray)")
_M["Sapphire"].variants["Malitson1972_extraordinary"] = \
    _M["Al2O3"].variants["Malitson1972_extraordinary"]
_M["LiNbO3"].variants["Zelmon1997_extraordinary"] = _sellmeier(
    [(2.9804, 0.02047), (0.5981, 0.0666), (8.9543, 416.08)],
    "D. E. Zelmon et al., J. Opt. Soc. Am. B 14, 3319 (1997) (extraordinary)")

_add("CrystalQuartz", "Ghosh1999_ordinary",
     Ghosh1999_ordinary=_sellmeier(
         [(0.28604141, 1e-8), (1.07044083, 1.00585997e-2),
          (1.10202242, 100.0)],
         "G. Ghosh, Opt. Commun. 163, 95 (1999) (ordinary ray)"),
     Ghosh1999_extraordinary=_sellmeier(
         [(0.28851804, 1e-8), (1.09509924, 1.02101864e-2),
          (1.15662475, 100.0)],
         "G. Ghosh, Opt. Commun. 163, 95 (1999) (extraordinary ray)"))

# additional fitted variants of existing materials
_M["cSi"].variants["SalzbergVilla1957"] = _sellmeier(
    [(10.6684293, 0.301516485**2), (0.0030434748, 1.13475115**2),
     (1.54133408, 1104.0**2)],
    "C. D. Salzberg and J. J. Villa, J. Opt. Soc. Am. 47, 244 (1957)")
_M["SiO2"].variants["Palik_Lossless"] = _M["SiO2"].variants["Malitson1965"]
_M["Ge"].variants["Barnes1979"] = _sellmeier(
    [(8.56934, 1e-8), (6.59891, 0.665904), (0.1292641, 62.1**2)],
    "N. P. Barnes and M. S. Piltch, J. Opt. Soc. Am. 69, 178 (1979) "
    "(n^2 form refit; 2-14 um)")
_M["H2O"].variants["Daimon2007"] = _sellmeier(
    [(0.5684027565, 0.005101829712), (0.1726177391, 0.01821153936),
     (0.02086189578, 0.02620722293), (0.1130748688, 10.69792721)],
    "M. Daimon and A. Masumura, Appl. Opt. 46, 3811 (2007) (20 C)")

# new dielectric materials
_add("Diamond", "Peter1923",
     Peter1923=_sellmeier(
         [(4.3356, 0.1060**2), (0.3306, 0.1750**2)],
         "F. Peter, Z. Phys. 15, 358 (1923); H. R. Phillip and E. A. Taft"))

_add("GeO2", "Fleming1984",
     Fleming1984=_sellmeier(
         [(0.80686642, 0.068972606**2), (0.71815848, 0.15396605**2),
          (0.85416831, 11.841931**2)],
         "J. W. Fleming, Appl. Opt. 23, 4486 (1984)"))

_add("BaF2", "Li1980",
     Li1980=_sellmeier(
         [(0.643356, 0.057789**2), (0.506762, 0.10968**2),
          (3.8261, 46.3864**2)],
         "H. H. Li, J. Phys. Chem. Ref. Data 9, 161 (1980)"))

_add("Y2O3", "Nigara1968",
     Nigara1968=_sellmeier(
         [(2.578, 0.1387**2), (3.935, 22.936**2)],
         "Y. Nigara, Jpn. J. Appl. Phys. 7, 404 (1968)"))

_add("AlAs", "FernOnton1971",
     FernOnton1971=_sellmeier(
         [(1.0792, 1e-8), (6.0840, 0.2822**2), (1.900, 27.62**2)],
         "R. E. Fern and A. Onton, J. Appl. Phys. 42, 3499 (1971)"))

_add("ZnTe", "Marple1964",
     Marple1964=_sellmeier(
         [(3.27, 1e-8), (3.01, 0.142)],
         "D. T. F. Marple, J. Appl. Phys. 35, 539 (1964) "
         "(n^2 = 4.27 + 3.01 L/(L-0.142))"))

_add("CdTe", "DeBell1979",
     DeBell1979=_sellmeier(
         [(6.1977889, 0.317069**2), (3.2243821, 72.0663**2)],
         "A. G. DeBell et al., Appl. Opt. 18, 3114 (1979) (6-22 um fit, "
         "accurate through the NIR)"))

_add("MgO", "StephensMalitson1952",
     StephensMalitson1952=_sellmeier(
         [(1.111033, 0.0712465**2), (0.8460085, 0.1375204**2),
          (7.808527, 26.89302**2)],
         "R. E. Stephens and I. H. Malitson, J. Res. NBS 49 (1952) "
         "(Sellmeier refit of the published dispersion)"))

# oxide/ceramic thin-film materials — single-resonance Lorentz models anchored
# at the commonly used telecom/visible index, with a UV pole giving the
# correct normal dispersion trend
_add("HfO2", "Lorentz",
     Lorentz=_lorentz(1.0, [(2.54, 1.9e15, 0.0)],
                      "UV-pole model anchored to n=1.88 @ 632 nm "
                      "(typical ALD film, cf. Al-Kuhaili 2004)"))

_add("Ta2O5", "Lorentz",
     Lorentz=_lorentz(1.0, [(3.28, 1.72e15, 0.0)],
                      "UV-pole model anchored to n=2.07 @ 1550 nm "
                      "(typical sputtered film, cf. Gao 2012)"))

_add("ZrO2", "Lorentz",
     Lorentz=_lorentz(1.0, [(3.55, 1.85e15, 0.0)],
                      "UV-pole model anchored to n=2.13 @ 632 nm "
                      "(cf. Wood & Nassau 1982)"))

_add("SiON", "Const",
     Const=_const(1.65, ref="mid-composition oxynitride @ 1.55 um"))

_add("SiO", "Const",
     Const=_const(1.9, ref="silicon monoxide film, visible (Hass 1950s)"))

# narrow-gap / III-V semiconductors (transparent-range index models)
_add("InAs", "Const",
     Const=_const(3.51, ref="n @ 3.7+ um transparent range (Palik tables)"))

_add("GaSb", "Const",
     Const=_const(3.82, ref="n @ 2+ um transparent range (Palik tables)"))

_add("InSb", "Const",
     Const=_const(3.95, ref="n @ 8-12 um transparent range (Palik tables)"))

_add("AlGaN", "Const",
     Const=_const(2.25, ref="Al0.3Ga0.7N visible (Brunner 1997 interp)"))

_add("AlGaAs", "Const",
     Const=_const(3.3, ref="Al0.3Ga0.7As @ 1.55 um (Gehrsitz 2000 interp)"))

# 2D-material bulk effective indices (in-plane, telecom band)
_add("MoSe2", "Const",
     Const=_const(4.25, 0.1, freq=C_0 / 1.55,
                  ref="bulk effective @ 1.55 um (Beal & Hughes 1979)"))

_add("WS2", "Const",
     Const=_const(4.0, 0.05, freq=C_0 / 1.55,
                  ref="bulk effective @ 1.55 um (Beal & Hughes 1979)"))

_add("WSe2", "Const",
     Const=_const(4.4, 0.1, freq=C_0 / 1.55,
                  ref="bulk effective @ 1.55 um (Beal & Hughes 1979)"))

# polymers / organics
_add("PET", "Const",
     Const=_const(1.575, ref="polyethylene terephthalate, visible"))

_add("PDMS", "Const",
     Const=_const(1.4, ref="Sylgard 184 @ 1.55 um (Schneider 2009)"))

_add("Parylene", "Const",
     Const=_const(1.62, ref="parylene-C, visible"))

_add("AminoAcid", "Const",
     Const=_const(1.55, ref="generic amino-acid film, visible"))

_add("AZO", "Drude",
     Drude=_drude_lorentz(
         3.8, [(1.6e15 / (2 * np.pi), 6.0e13 / (2 * np.pi))], [],
         "Al:ZnO Drude model, epsilon_inf + plasma edge near 1.3 um "
         "(cf. Naik 2013)"))

# --------------------------------------------------------------------------- #
# metals (Drude-Lorentz parameters: Rakic et al., Appl. Opt. 37, 5271 (1998))
# plasma frequencies/damping in eV converted to Hz
# --------------------------------------------------------------------------- #


def _metal_rakic(eps_inf, wp_ev, f0, gamma0_ev, lorentz_terms, ref):
    """Drude + Lorentz metal model from Rakic-style (f_j, Gamma_j, w_j) eV data."""
    drude = [(np.sqrt(f0) * wp_ev * EV_TO_HZ, gamma0_ev * EV_TO_HZ)]
    lorentz = []
    for f_j, gamma_j, w_j in lorentz_terms:
        de = f_j * wp_ev**2 / max(w_j, 1e-6)**2
        lorentz.append((de, w_j * EV_TO_HZ, gamma_j * EV_TO_HZ / 2))
    return _drude_lorentz(eps_inf, drude, lorentz, ref)


_RAKIC = "A. D. Rakic et al., Appl. Opt. 37, 5271 (1998) (LD model)"

# Brendel-Bormann variants: the BB model (Gaussian-broadened oscillators,
# Rakic et al. 1998 Table 1) evaluated via the Faddeeva function over
# 0.4-12 um and fitted to pole-residue form with this package's own
# FastDispersionFitter (scripts/fit_bb_metals.py; fit rms on eps: Au
# 1.5e-4, Ag 3.1e-4, Al 1.0e-2, Cu 0.29, W 1.5 — the Cu/W residual is
# concentrated in the huge-|eps| IR tail; n/k agree to ~3% everywhere).
_RAKIC_BB = ("A. D. Rakic et al., Appl. Opt. 37, 5271 (1998) "
             "(BB model, fitted to pole-residue with tidy3d_tpu "
             "FastDispersionFitter)")


def _pole_residue(eps_inf, poles, ref):
    from ..components.medium import PoleResidue

    return VariantItem(
        medium=PoleResidue(eps_inf=eps_inf, poles=tuple(poles)),
        reference=ref)


_BB_FITS = {
    "Au": dict(eps_inf=1.0359234657379517, poles=[
        ((-3605520639507588 - 4839166608046143j), (1.8004247009723434e+16 + 5.183417171550635e+16j)),
        ((-1254131980526373.5 - 4743738333907382j), (-7896517044496155 - 3250655994291638.5j)),
        ((-1320168472631218 - 3779334493663463.5j), (5903415382678396 - 6777785742720908j)),
        ((-2908017203398686 - 0j), (-2.308124644203077e+16 + 0j)),
        ((-11270172020.7635 - 0j), (9.556570549190006e+17 - 0j)),
        ((-76064593156259.1 - 0j), (-9.562076904336547e+17 - 0j)),
        ((-94962071387837.17 - 0j), (5959583204672381 - 0j)),
    ]),
    "Ag": dict(eps_inf=1.7652545306253502, poles=[
        ((-707510848300639 - 6777129104597849j), (1541105454041775.8 + 2285498551674141.5j)),
        ((-4507849755080372 - 0j), (645974704714467.4 + 0j)),
        ((-247202423090017.97 - 0j), (522523409804317.6 - 0j)),
        ((-3358018327.453941 - 0j), (1.0335603038424901e+18 - 0j)),
        ((-74435488700541.78 - 0j), (-1.0329319176719095e+18 - 0j)),
    ]),
    "Al": dict(eps_inf=1.0393297430010966, poles=[
        ((-1273317062128016.8 - 2495769184132171.5j), (1230562070208950.2 + 2.200997874927397e+16j)),
        ((-301524453881725.4 - 2365932502058620j), (-1730151737043620.2 + 1.0363198914325264e+16j)),
        ((-471617863992079.3 - 2252476792756775j), (35918151102488.19 - 5464326205806458j)),
        ((-245108562767164.88 - 95565866503224.62j), (-3.911614930463108e+16 + 5.171387780210279e+17j)),
        ((-84014562434.98825 - 0j), (1.9165105042292864e+18 - 0j)),
        ((-70390938955277.14 - 0j), (-1.8769787768974144e+18 - 0j)),
    ]),
    "Cu": dict(eps_inf=1.0, poles=[
        ((-1107505928883126 - 3722921960373473j), (4701387782517149 + 2526211705513491.5j)),
        ((-1880928787366138.8 - 1521253886919529j), (-2826330540258498.5 - 1.918194439854656e+16j)),
        ((-74094713304.07933 - 0j), (1.6791738633322732e+18 - 0j)),
        ((-45399118576688.02 - 0j), (-1.6676958941217052e+18 - 0j)),
    ]),
    "W": dict(eps_inf=1.0, poles=[
        ((-5354077855481980 - 5400992017361780j), (2.091934326444128e+16 + 8.219559915587179e+16j)),
        ((-1637940174884270.5 - 2838594651921914j), (-5637677489127804 + 1.7665347185160586e+16j)),
        ((-307496882279801.44 - 1564810996152735.8j), (-2280351379480121.5 + 1289892563040588j)),
        ((-308177793672825.5 - 1390748601341109.5j), (2314606999326387.5 + 1438296949228743.5j)),
        ((-1168078702140171.8 - 0j), (2915368650235549.5 + 0j)),
        ((-370750896397824.6 - 0j), (727283580894332.5 - 0j)),
        ((-7921779635.4704485 - 0j), (4.5911195062695904e+17 - 0j)),
        ((-86575780249980.06 - 0j), (-4.5855408302251814e+17 - 0j)),
    ]),
}

_add("Au", "RakicLorentzDrude1998",
     RakicLorentzDrude1998=_metal_rakic(
         1.0, 9.03, 0.760, 0.053,
         [(0.024, 0.241, 0.415), (0.010, 0.345, 0.830),
          (0.071, 0.870, 2.969), (0.601, 2.494, 4.304),
          (4.384, 2.214, 13.32)], _RAKIC),
     RakicBrendelBormann1998=_pole_residue(ref=_RAKIC_BB, **_BB_FITS["Au"]),
     Olmon2012Drude=_metal_rakic(
         1.0, 8.5, 1.0, 0.048, [],
         "R. L. Olmon et al., PRB 86, 235147 (2012) (evaporated gold, "
         "Drude parameters; IR-valid)"))

_add("Ag", "RakicLorentzDrude1998",
     RakicLorentzDrude1998=_metal_rakic(
         1.0, 9.01, 0.845, 0.048,
         [(0.065, 3.886, 0.816), (0.124, 0.452, 4.481),
          (0.011, 0.065, 8.185), (0.840, 0.916, 9.083),
          (5.646, 2.419, 20.29)], _RAKIC),
     RakicBrendelBormann1998=_pole_residue(ref=_RAKIC_BB, **_BB_FITS["Ag"]))

_add("Al", "RakicLorentzDrude1998",
     RakicLorentzDrude1998=_metal_rakic(
         1.0, 14.98, 0.523, 0.047,
         [(0.227, 0.333, 0.162), (0.050, 0.312, 1.544),
          (0.166, 1.351, 1.808), (0.030, 3.382, 3.473)], _RAKIC),
     RakicBrendelBormann1998=_pole_residue(ref=_RAKIC_BB, **_BB_FITS["Al"]))

_add("Cu", "RakicLorentzDrude1998",
     RakicLorentzDrude1998=_metal_rakic(
         1.0, 10.83, 0.575, 0.030,
         [(0.061, 0.378, 0.291), (0.104, 1.056, 2.957),
          (0.723, 3.213, 5.300), (0.638, 4.305, 11.18)], _RAKIC),
     RakicBrendelBormann1998=_pole_residue(ref=_RAKIC_BB, **_BB_FITS["Cu"]))

_add("W", "RakicLorentzDrude1998",
     RakicLorentzDrude1998=_metal_rakic(
         1.0, 13.22, 0.206, 0.064,
         [(0.054, 0.530, 1.004), (0.166, 1.281, 1.917),
          (0.706, 3.332, 3.580), (2.590, 5.836, 7.498)], _RAKIC),
     RakicBrendelBormann1998=_pole_residue(ref=_RAKIC_BB, **_BB_FITS["W"]))

_add("Ti", "RakicLorentzDrude1998",
     RakicLorentzDrude1998=_metal_rakic(
         1.0, 7.29, 0.148, 0.082,
         [(0.899, 2.276, 0.777), (0.393, 2.518, 1.545),
          (0.187, 1.663, 2.509), (0.001, 1.762, 19.43)], _RAKIC))

_add("Ni", "RakicLorentzDrude1998",
     RakicLorentzDrude1998=_metal_rakic(
         1.0, 15.92, 0.096, 0.048,
         [(0.100, 4.511, 0.174), (0.135, 1.334, 0.582),
          (0.106, 2.178, 1.597), (0.729, 6.292, 6.089)], _RAKIC))

_add("Cr", "RakicLorentzDrude1998",
     RakicLorentzDrude1998=_metal_rakic(
         1.0, 10.75, 0.168, 0.047,
         [(0.151, 3.175, 0.121), (0.150, 1.305, 0.543),
          (1.149, 2.676, 1.970), (0.825, 1.335, 8.775)], _RAKIC))

_add("Pt", "RakicLorentzDrude1998",
     RakicLorentzDrude1998=_metal_rakic(
         1.0, 9.59, 0.333, 0.080,
         [(0.191, 0.517, 0.780), (0.659, 1.838, 1.314),
          (0.547, 3.668, 3.141), (3.576, 8.517, 9.249)], _RAKIC))

_add("Pd", "RakicLorentzDrude1998",
     RakicLorentzDrude1998=_metal_rakic(
         1.0, 9.72, 0.330, 0.008,
         [(0.649, 2.950, 0.336), (0.121, 0.555, 0.501),
          (0.638, 4.621, 1.659), (0.453, 3.236, 5.715)], _RAKIC))

_add("Be", "RakicLorentzDrude1998",
     RakicLorentzDrude1998=_metal_rakic(
         1.0, 18.51, 0.084, 0.035,
         [(0.031, 1.664, 0.100), (0.140, 3.395, 1.032),
          (0.530, 4.454, 3.183), (0.130, 1.802, 4.604)], _RAKIC))

def _metal_from_nk(n, k, freq, ref):
    """Single-frequency metallic (eps_real < 0 allowed) Drude match."""
    eps = (n + 1j * k) ** 2
    w0 = 2 * np.pi * freq
    A, B = 1.0 - eps.real, eps.imag
    gamma = B * w0 / max(A, 1e-6)
    wp2 = w0**2 * (A + B**2 / max(A, 1e-6))
    fp = np.sqrt(max(wp2, 0.0)) / (2 * np.pi)
    return VariantItem(medium=Drude(eps_inf=1.0, coeffs=((fp, gamma / (2 * np.pi)),)),
                       reference=ref)


_add("TiN", "Const", Const=_metal_from_nk(1.8, 3.0, 1.934e14,
                                          ref="typical sputtered TiN @ 1.55 um"))

_add("TaN", "Const", Const=_metal_from_nk(2.4, 1.7, 1.934e14,
                                          ref="typical TaN @ 1.55 um"))


# --------------------------------------------------------------------------- #
# frequency-validity metadata (reference parity: every library variant in
# /root/reference/tidy3d/material_library/material_library.py carries a
# ``frequency_range`` on its medium; Simulation warns when sources drive a
# medium outside it). Ranges below are the wavelength validity windows of the
# cited fits/measurements, in um; constant-index entries get a band around
# their anchor wavelength.
# --------------------------------------------------------------------------- #

_VALID_UM: Dict[str, Dict[str, tuple]] = {
    "SiO2": {"Malitson1965": (0.21, 3.71), "Palik_Lossless": (0.21, 3.71)},
    "cSi": {"Li1993_293K": (1.2, 14.0), "SalzbergVilla1957": (1.36, 11.0),
            "Green2008": (0.5, 1.2)},
    "aSi": {"Pierce1972": (0.6, 2.5)},
    "Si3N4": {"Luke2015": (0.31, 5.5), "Luke2015Sellmeier": (0.31, 5.5),
              "Philipp1973": (0.207, 1.24),
              "Philipp1973Sellmeier": (0.207, 1.24)},
    "SiN": {"Luke2015": (0.31, 5.5)},
    "Ge": {"Icenogle1976": (2.5, 12.0), "Barnes1979": (2.0, 14.0)},
    "GaAs": {"Skauli2003": (0.97, 17.0)},
    "InP": {"Pettit1965": (0.95, 10.0)},
    "GaN": {"Barker1973": (0.35, 10.0)},
    "AlN": {"Pastrnak1966": (0.22, 5.0)},
    "Al2O3": {"Malitson1972": (0.2, 5.5),
              "Malitson1972_extraordinary": (0.2, 5.5)},
    "Sapphire": {"Malitson1972": (0.2, 5.5),
                 "Malitson1972_extraordinary": (0.2, 5.5)},
    "TiO2": {"Devore1951": (0.43, 1.53)},
    "MgF2": {"Dodge1984": (0.2, 7.0), "Dodge1984_extraordinary": (0.2, 7.0)},
    "CaF2": {"Malitson1963": (0.23, 9.7)},
    "BK7": {"SCHOTT": (0.3, 2.5)},
    "SF10": {"SCHOTT": (0.38, 2.5)},
    "SF11": {"SCHOTT": (0.37, 2.5)},
    "FusedSilica": {"Malitson1965": (0.21, 3.71),
                    "ZemaxSellmeier": (0.21, 3.71)},
    "PMMA": {"Sultanova2009": (0.437, 1.052)},
    "Polycarbonate": {"Sultanova2009": (0.437, 1.052)},
    "Polystyrene": {"Sultanova2009": (0.437, 1.052)},
    "Cellulose": {"Sultanova2009": (0.437, 1.052)},
    "PEI": {"Sultanova2009": (0.437, 1.052)},
    "PEN": {"Sultanova2009": (0.437, 1.052)},
    "PTFE": {"Yang2017": (0.4, 2.0)},
    "PVC": {"Zhang2020": (0.4, 2.0)},
    "SU8": {"Const": (1.2, 2.0)},
    "BCB": {"Const": (1.2, 2.0)},
    "ITO": {"Konig2014": (0.4, 3.0)},
    "H2O": {"Hale1973": (0.2, 2.0), "Daimon2007": (0.18, 1.13)},
    "D2O": {"Hale1973": (0.2, 2.0)},
    "YAG": {"Zelmon1998": (0.4, 5.0)},
    "ZnO": {"Bond1965": (0.45, 4.0)},
    "ZnS": {"Debenham1984": (0.405, 13.0)},
    "ZnSe": {"Connolly1979": (0.54, 18.2)},
    "LiNbO3": {"Zelmon1997": (0.4, 5.0), "Zelmon1997_extraordinary": (0.4, 5.0)},
    "GaP": {"Bond1965": (0.44, 3.4)},
    "SiC": {"Shaffer1971": (0.47, 0.69)},
    "InGaAs": {"Const": (1.3, 1.8)},
    "MoS2": {"Const": (1.3, 1.8)},
    "Graphene_substrate": {"Const": (0.4, 2.0)},
    "CrystalQuartz": {"Ghosh1999_ordinary": (0.198, 2.05),
                      "Ghosh1999_extraordinary": (0.198, 2.05)},
    "Diamond": {"Peter1923": (0.22, 2.5)},
    "GeO2": {"Fleming1984": (0.36, 4.3)},
    "BaF2": {"Li1980": (0.27, 10.3)},
    "Y2O3": {"Nigara1968": (0.25, 9.6)},
    "AlAs": {"FernOnton1971": (0.56, 2.2)},
    "ZnTe": {"Marple1964": (0.58, 2.5)},
    "CdTe": {"DeBell1979": (1.0, 22.0)},
    "MgO": {"StephensMalitson1952": (0.36, 5.4)},
    "HfO2": {"Lorentz": (0.4, 2.0)},
    "Ta2O5": {"Lorentz": (0.4, 2.0)},
    "ZrO2": {"Lorentz": (0.4, 2.0)},
    "SiON": {"Const": (1.2, 2.0)},
    "SiO": {"Const": (0.4, 2.0)},
    "InAs": {"Const": (3.7, 12.0)},
    "GaSb": {"Const": (2.0, 12.0)},
    "InSb": {"Const": (8.0, 12.0)},
    "AlGaN": {"Const": (0.4, 0.8)},
    "AlGaAs": {"Const": (1.2, 2.0)},
    "MoSe2": {"Const": (1.3, 1.8)},
    "WS2": {"Const": (1.3, 1.8)},
    "WSe2": {"Const": (1.3, 1.8)},
    "PET": {"Const": (0.4, 0.8)},
    "PDMS": {"Const": (1.2, 2.0)},
    "Parylene": {"Const": (0.4, 0.8)},
    "AminoAcid": {"Const": (0.4, 0.8)},
    "AZO": {"Drude": (1.0, 3.0)},
    "Au": {"RakicLorentzDrude1998": (0.25, 12.4),
           "RakicBrendelBormann1998": (0.4, 12.0),
           "Olmon2012Drude": (2.0, 25.0)},
    "Ag": {"RakicLorentzDrude1998": (0.25, 12.4),
           "RakicBrendelBormann1998": (0.4, 12.0)},
    "Al": {"RakicLorentzDrude1998": (0.25, 12.4),
           "RakicBrendelBormann1998": (0.4, 12.0)},
    "Cu": {"RakicLorentzDrude1998": (0.25, 12.4),
           "RakicBrendelBormann1998": (0.4, 12.0)},
    "W": {"RakicLorentzDrude1998": (0.25, 12.4),
          "RakicBrendelBormann1998": (0.4, 12.0)},
    "Ti": {"RakicLorentzDrude1998": (0.25, 12.4)},
    "Ni": {"RakicLorentzDrude1998": (0.25, 12.4)},
    "Cr": {"RakicLorentzDrude1998": (0.25, 12.4)},
    "Pt": {"RakicLorentzDrude1998": (0.25, 12.4)},
    "Pd": {"RakicLorentzDrude1998": (0.25, 12.4)},
    "Be": {"RakicLorentzDrude1998": (0.25, 12.4)},
    "TiN": {"Const": (1.3, 1.8)},
    "TaN": {"Const": (1.3, 1.8)},
}


def _apply_valid_ranges():
    """Stamp frequency_range onto every variant's medium.

    Alias variants share one medium object; the id-keyed cache preserves that
    sharing so alias entries stay identity-equal (the distinct-variant tally
    excludes them by id)."""
    stamped: Dict[int, object] = {}
    for mname, mat in _M.items():
        for vname, var in mat.variants.items():
            lam = _VALID_UM.get(mname, {}).get(vname)
            if lam is None:
                # a builder-supplied frequency_range (e.g. _sellmeier's
                # rng) is an acceptable fallback; raising here would make
                # the whole package unimportable after adding an entry
                if var.medium.frequency_range is None:
                    from ..log import log

                    log.warning(
                        f"material_library: {mname}/{vname} has no "
                        "validity range in _VALID_UM and none from its "
                        "fit builder — frequency_range left unset.")
                continue
            if var.medium.frequency_range is not None:
                # the fit builder already stamped a range; keep it (the
                # table must not silently win on disagreement)
                continue
            key = id(var.medium)
            if key not in stamped:
                frange = (C_0 / lam[1], C_0 / lam[0])
                stamped[key] = var.medium.updated_copy(frequency_range=frange)
            mat.variants[vname] = VariantItem(
                medium=stamped[key], reference=var.reference,
                data_url=var.data_url)


_apply_valid_ranges()

material_library: Dict[str, MaterialItem] = _M
