"""Forged and norm-violating copies of a response.

A frozen copy of ``tampered`` in the repository's ``chip_smoke.py`` (as of
the commit that added this benchmark), unchanged, so that the benchmark's
probes stay what they are when that script changes.
"""

from __future__ import annotations


def tampered(proto: str, resp, vb1: int, int64_min: bool) -> dict:
    """Forged and norm-violating copies of a response, keyed by the name of
    the verdict they give in the known-answer files (as
    scripts/make_torch_kat.py makes them); with ``int64_min`` (wide rings)
    also one whose first z coefficient is -2^63, where |z| wraps in int64."""
    zname = "zs" if proto == "sum" else "z"
    z = getattr(resp, zname)
    first = (..., 0, 0, 0) if proto == "sum" else (..., 0, 0)
    z_f, z_n = z.clone(), z.clone()
    z_f[(..., 1, 0, 0) if proto == "sum" else first] += 3 if proto == "sum" else 1
    z_n[first] = vb1
    out = {"ok_forged": resp._replace(**{zname: z_f}), "ok_norm": resp._replace(**{zname: z_n})}
    if int64_min:
        z_m = z.clone()
        z_m[first] = -2**63
        out["ok_int64_min"] = resp._replace(**{zname: z_m})
    if proto != "open":
        zp_f = resp.zp.clone()
        zp_f[..., 0, 0] += 1
        out["ok_forged_zp"] = resp._replace(zp=zp_f)
    return out
