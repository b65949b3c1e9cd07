"""adiabaticFlameT, mixtureAdiabaticFlameT and chemkinToFoam (a host
copy of openfoam-2.2.x_tpu/apps/thermoutils.py, unchanged in behaviour;
the reference module is loaded through the JAX package). The flame
temperature solvers run on janaf (NASA-7) species thermo in float64 on
the host, from dictionaries read by core/dictionary.py as
models/thermo.py reads them; chemkinToFoam converts a CHEMKIN-II
mechanism and fixed-column NASA thermo data into the foamChemistry
dictionary pair that reactingFoam reads (a direct parser, not a lex/yacc
port of the reference's chemkinReader).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

R_UNIV = 8314.47          # J/kmol/K
CAL = 4184.0              # J per kcal (CHEMKIN E in cal/mol)


# ---------------------------------------------------------------------------
# janaf species helpers (host, f64)
# ---------------------------------------------------------------------------


def _janaf_h(coeffs_lo, coeffs_hi, T_common, W, T):
    """Absolute enthalpy h(T) [J/kg]."""
    a = coeffs_lo if T < T_common else coeffs_hi
    h_RT = (a[0] + a[1] * T / 2 + a[2] * T ** 2 / 3 + a[3] * T ** 3 / 4
            + a[4] * T ** 4 / 5 + a[5] / T)
    return h_RT * R_UNIV * T / W


def _janaf_cp(coeffs_lo, coeffs_hi, T_common, W, T):
    a = coeffs_lo if T < T_common else coeffs_hi
    return (a[0] + a[1] * T + a[2] * T ** 2 + a[3] * T ** 3
            + a[4] * T ** 4) * R_UNIV / W


def _species_from_dict(entry) -> Tuple[float, List[float], List[float],
                                       float]:
    spec = entry.get("specie", {})
    W = float(spec.get("molWeight", 28.96))
    th = entry.get("thermodynamics", {})
    lo = [float(x) for x in th.get("lowCpCoeffs", [])]
    hi = [float(x) for x in th.get("highCpCoeffs", lo)]
    Tc = float(th.get("Tcommon", 1000.0))
    return W, lo, hi, Tc


def mixture_h(thermo: Dict, comp: Dict[str, float], T: float,
              by_mole: bool = True) -> Tuple[float, float]:
    """(h [J/kg], Cp [J/kg/K]) of a mixture at T. comp: mole (or mass)
    fractions."""
    names = list(comp)
    fr = np.array([comp[n] for n in names], float)
    fr = fr / fr.sum()
    Ws, hs, cps = [], [], []
    for n in names:
        W, lo, hi, Tc = _species_from_dict(thermo[n])
        Ws.append(W)
        hs.append(_janaf_h(lo, hi, Tc, W, T))
        cps.append(_janaf_cp(lo, hi, Tc, W, T))
    Ws = np.array(Ws)
    if by_mole:
        mass = fr * Ws
        Y = mass / mass.sum()
    else:
        Y = fr
    return float((Y * hs).sum()), float((Y * cps).sum())


def adiabatic_flame_T(thermo: Dict, reactants: Dict[str, float],
                      products: Dict[str, float], T0: float = 300.0,
                      by_mole: bool = True) -> float:
    """Tad such that h_products(Tad) == h_reactants(T0) (reference:
    adiabaticFlameT.C's Newton on the janaf mixture)."""
    h0, _ = mixture_h(thermo, reactants, T0, by_mole)
    T = 2000.0
    for _ in range(50):
        h, cp = mixture_h(thermo, products, T, by_mole)
        dT = (h0 - h) / max(cp, 1e-3)
        T = min(max(T + dT, 200.0), 5000.0)
        if abs(dT) < 1e-8:
            break
    return T


# ---------------------------------------------------------------------------
# CHEMKIN-II conversion
# ---------------------------------------------------------------------------


def parse_chemkin_thermo(text: str) -> Dict[str, Dict]:
    """Fixed-column NASA-7 thermo data (THERMO ... END): 4 lines per
    species; returns foam-style thermo dicts."""
    lines = [ln.rstrip("\n") for ln in text.splitlines()]
    out: Dict[str, Dict] = {}
    i = 0
    while i < len(lines):
        ln = lines[i]
        if len(ln) >= 80 and ln[79:80] == "1":
            name = ln[:18].split()[0]
            try:
                T_lo = float(ln[45:55])
                T_hi = float(ln[55:65])
                T_co = float(ln[65:73] or 1000.0)
            except ValueError:
                i += 1
                continue

            def nums(row, n):
                return [float(row[15 * k:15 * (k + 1)])
                        for k in range(n)]

            hi = nums(lines[i + 1], 5) + nums(lines[i + 2], 2)
            lo = nums(lines[i + 2][30:], 3) + nums(lines[i + 3], 4)
            out[name] = {"Tlow": T_lo, "Thigh": T_hi, "Tcommon": T_co,
                         "high": hi, "low": lo}
            i += 4
        else:
            i += 1
    return out


_W_ELEM = {"H": 1.00794, "C": 12.011, "O": 15.9994, "N": 14.0067,
           "AR": 39.948, "HE": 4.0026, "S": 32.065}


def _mol_weight(name: str) -> float:
    """Molecular weight from the species formula (e.g. CH4, C3H8,
    H2O, OH, N2)."""
    w = 0.0
    for sym, cnt in re.findall(r"([A-Z][a-z]?)(\d*)", name.upper()):
        if sym in _W_ELEM:
            w += _W_ELEM[sym] * (int(cnt) if cnt else 1)
    return w or 28.96


def parse_chemkin_mech(text: str) -> Tuple[List[str], List[Dict]]:
    """(species, reactions) from a CHEMKIN-II mechanism. Arrhenius
    k = A T^b exp(-E/RT), E in cal/mol (the CHEMKIN default).
    Third-body (+M), pressure-dependent (LOW/TROE) and duplicate
    annotations are skipped with the base Arrhenius retained
    (documented simplification)."""
    text = re.sub(r"!.*", "", text)
    m = re.search(r"SPEC(?:IES)?\s+(.*?)\s+END", text,
                  re.S | re.I)
    species = m.group(1).split() if m else []
    m = re.search(r"REAC(?:TIONS)?[^\n]*\n(.*?)\s*END", text,
                  re.S | re.I)
    rxns: List[Dict] = []
    if m:
        for ln in m.group(1).splitlines():
            ln = ln.strip()
            if (not ln or ln.upper().startswith(("LOW", "TROE", "REV",
                                                 "DUP", "PLOG"))
                    or "/" in ln.split()[0]):
                continue
            mm = re.match(r"(.+?)\s+([\d.eE+-]+)\s+([\d.eE+-]+)\s+"
                          r"([\d.eE+-]+)\s*$", ln)
            if not mm:
                continue
            eq, A, b, E = mm.groups()
            eq = eq.replace("<=>", "=").replace("=>", "=")
            eq = re.sub(r"\(\+M\)", "", eq).replace("+M", "")
            if "=" not in eq:
                continue
            lhs, rhs = eq.split("=", 1)

            def side(s):
                out = []
                for tok in s.split("+"):
                    tok = tok.strip()
                    if not tok:
                        continue
                    mm2 = re.match(r"^(\d*\.?\d*)\s*(.+)$", tok)
                    coef = mm2.group(1)
                    out.append((mm2.group(2).strip(),
                                float(coef) if coef else 1.0))
                return out

            rxns.append({"lhs": side(lhs), "rhs": side(rhs),
                         "A": float(A), "beta": float(b),
                         "Ta": float(E) * CAL / R_UNIV})
    return species, rxns


def chemkin_to_foam(chem_path: str, thermo_path: str,
                    out_reactions: str, out_thermo: str) -> int:
    """Write the foamChemistry dictionary pair (reference:
    chemkinToFoam.C). Returns the reaction count."""
    species, rxns = parse_chemkin_mech(open(chem_path).read())
    thermo = parse_chemkin_thermo(open(thermo_path).read())

    def eqstr(r):
        def side(terms):
            return " + ".join(
                (f"{c:g}" if c != 1.0 else "") + n for n, c in terms)
        return f"{side(r['lhs'])} = {side(r['rhs'])}"

    with open(out_reactions, "w") as f:
        f.write("FoamFile { version 2.0; format ascii; "
                "class dictionary; object reactions; }\n")
        f.write("species\n(\n" + "\n".join(f"    {s}" for s in species)
                + "\n);\n\nreactions\n{\n")
        for i, r in enumerate(rxns):
            f.write(f"    r{i}\n    {{\n"
                    f"        type reversibleArrheniusReaction;\n"
                    f"        reaction \"{eqstr(r)}\";\n"
                    f"        A {r['A']:g};\n"
                    f"        beta {r['beta']:g};\n"
                    f"        Ta {r['Ta']:g};\n    }}\n")
        f.write("}\n")
    with open(out_thermo, "w") as f:
        f.write("FoamFile { version 2.0; format ascii; "
                "class dictionary; object thermo; }\n")
        for s in species:
            t = thermo.get(s)
            if t is None:
                continue
            W = _mol_weight(s)
            f.write(f"{s}\n{{\n    specie {{ nMoles 1; molWeight "
                    f"{W:g}; }}\n    thermodynamics\n    {{\n"
                    f"        Tlow {t['Tlow']:g}; Thigh "
                    f"{t['Thigh']:g}; Tcommon {t['Tcommon']:g};\n"
                    f"        highCpCoeffs ( "
                    + " ".join(f"{x:g}" for x in t["high"])
                    + " );\n        lowCpCoeffs ( "
                    + " ".join(f"{x:g}" for x in t["low"])
                    + " );\n    }\n"
                    "    transport { As 1.67212e-06; Ts 170.672; }\n"
                    "}\n")
    return len(rxns)
