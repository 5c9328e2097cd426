"""solid-waffle / linearity-fit configuration emitters.

Python equivalents of the reference's Perl generators
(``runs/summer2025run/write_solid-waffle_config.pl``,
``write_linearity_config.pl``, and ``runs/2026_July`` variants, plus
``mapping.pl``): they emit the text/JSON configurations consumed by the
external solid-waffle characterization tool.  Only the *output formats*
of solid-waffle are consumed by this framework (SURVEY.md §2.3).
"""

import json

from ..config import resolve_device
from . import add_device_argument


def solid_waffle_config(target_dir, sca, estart, eend, *, fmt=6,
                        nbin=(32, 32), time_steps=(2, 8, 9, 15),
                        char="Advanced 1 3 3 bfe"):
    """Correlation-run configuration text (one background run's worth).

    Returns (config_text, summary_file_line).
    """
    lines = [f"DETECTOR: SCA{sca:02d}", "LIGHT:"]
    for e in range(estart, eend + 1):
        lines.append(f"{target_dir}/99999999_SCA{sca:02d}_Flat_{e:03d}.fits")
    lines.append("DARK:")
    for e in range(estart, eend + 1):
        lines.append(f"{target_dir}/99999999_SCA{sca:02d}_Noise_{e:03d}.fits")
    lines += [
        f"FORMAT: {fmt}",
        f"CHAR: {char}",
        "TIMEREF: 1",
        f"NBIN: {nbin[0]} {nbin[1]}",
        "FULLNL: True True True",
        "NLPOLY: 3 2 16",
        "IPCSUB: True",
        "TIME: " + " ".join(str(t) for t in time_steps),
        f"OUTPUT: {target_dir}/sw-SCA{sca:02d}-E{estart:03d}",
        "HOTPIX: 1000 2000 0.1 0.1",
    ]
    summary = f"{target_dir}/sw-SCA{sca:02d}-E{estart:03d}_summary.txt"
    return "\n".join(lines) + "\n", summary


def linearity_config(target_dir, sca, tag, *, fmt=6, tframe=3.04,
                     tstart=2, p_order=10, slopecut=0.5, sign=1,
                     negativepad=500, bias_slice=1,
                     nramps=(50, 30, 25)):
    """Linearity-fit JSON configuration (high flat / low flat / dark
    ramp groups, bias from the dark reference file)."""
    sca2 = f"{sca:02d}"
    ramps = []
    for kind, n in zip(("Flat", "LoFlat", "Noise"), nramps):
        ramps.append(
            {
                "FORMAT": fmt,
                "FILE": f"{target_dir}/99999999_SCA{sca2}_{kind}_001.fits",
                "START": 1,
                "NRAMP": n,
                "TSTART": tstart,
            }
        )
    cfg = {
        "SCA": int(sca),
        "RAMPS": ramps,
        "DARK": -1,
        "TFRAME": tframe,
        "P_ORDER": p_order,
        "OUTPUT": f"{target_dir}/roman_wfi_linearitylegendre_{tag}_SCA{sca2}.asdf",
        "SIGN": sign,
        "SLOPECUT": slopecut,
        "BIAS": {
            "FILE": f"{target_dir}/roman_wfi_dark_{tag}_SCA{sca2}.asdf",
            "PATH": ["roman", "data"],
            "SLICE": bias_slice,
        },
        "NEGATIVEPAD": negativepad,
    }
    return json.dumps(cfg, indent=2)


def main(argv=None):
    """``swconfig correlation <target_dir> <sca> <estart> <eend>`` or
    ``swconfig linearity <target_dir> <sca> <tag>`` — the reference's
    Perl config generators as one CLI; writes the config text to stdout
    or ``--out``."""
    import argparse
    import sys as _sys

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="mode", required=True)
    pc = sub.add_parser("correlation")
    pc.add_argument("target_dir")
    pc.add_argument("sca", type=int)
    pc.add_argument("estart", type=int)
    pc.add_argument("eend", type=int)
    pc.add_argument("--out", default=None)
    pl = sub.add_parser("linearity")
    pl.add_argument("target_dir")
    pl.add_argument("sca", type=int)
    pl.add_argument("tag")
    pl.add_argument("--out", default=None)
    for sp in (pc, pl):
        add_device_argument(sp)
    a = p.parse_args(argv)
    resolve_device(a.device)  # host code: checked as in every calib CLI

    if a.mode == "correlation":
        txt, summary = solid_waffle_config(a.target_dir, a.sca, a.estart,
                                           a.eend)
        trailer = f"# summary: {summary}\n"
    else:
        txt = linearity_config(a.target_dir, a.sca, a.tag)
        trailer = ""
    if a.out:
        with open(a.out, "w") as f:
            f.write(txt)
        print(">>", a.out)
        if trailer:
            print(trailer, end="")
    else:
        _sys.stdout.write(txt + trailer)
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
