"""Result plotting + published reference curves (SURVEY §2.4 L9 layer;
copied from polardecoding_tpu.plotting).

Replaces the reference's plot scripts (plot_SCL.py, SCL_1024.py): log-scale
BLER curves of our Monte-Carlo results overlaid on the reference's archived
tables (BASELINE.md) and the third-party "Po-Chung" oracle curves the
reference itself validates against (plot_SCL.py:65-70, SCL_1024.py:73-78).
"""
from __future__ import annotations

import json
from typing import Iterable, Optional

# Published reference BLER tables (from the reference's result archives;
# transcribed in BASELINE.md with provenance).  snr grid is 1.0 + 0.5 k.
REFERENCE_BLER = {
    "SC_128": {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0],
        "bler": [0.3968, 0.2747, 0.1414, 0.06645, 0.02098, 6.499e-3, 1.880e-3],
        "source": "myResult_128.zip:SC128out.txt (seed 1024)",
    },
    "BP_128": {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0],
        "bler": [0.4016, 0.2564, 0.1127, 0.05203, 0.01586, 4.941e-3, 1.740e-3],
        "source": "myResult_128.zip:BP128out.txt",
    },
    "BP_128_SPA": {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0],
        "bler": [0.4049, 0.2710, 0.1166, 0.05214, 0.01845, 5.226e-3, 1.845e-3],
        "source": "myResult_128.zip:BP128out_SPA.txt",
    },
    "SCL_128_L8": {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0, 3.5],
        "bler": [0.2361, 0.1237, 0.0552, 0.02405, 8.86e-3, 3.34e-3],
        "source": "plot_SCL.py 3-seed average, L=8",
    },
    "CASCL_128_L8": {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0],
        "bler": [0.2475, 0.1155, 0.03773, 9.98e-3, 1.772e-3],
        "source": "myResult_128.zip:CASCL_128_L8.txt (first seed)",
    },
    "CASCL_128_L32": {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0, 3.5],
        "bler": [0.1470, 0.06623, 0.01845, 4.025e-3, 9.83e-4, 1.890e-4],
        "source": "myResult_128.zip:CASCL_128_L32.txt (seed 2525)",
    },
    "SC_1024": {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0],
        "bler": [0.7299, 0.3745, 0.09009, 0.01451, 1.768e-3, 1.964e-4, 2.267e-5],
        "source": "myResult_1024.zip:SC1024out.dat (seed 1024)",
    },
    "BP_1024": {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0, 3.5],
        "bler": [0.4425, 0.1364, 0.02948, 7.592e-3, 1.130e-3, 1.951e-4],
        "source": "myResult_1024.zip:BP1024out.dat (seed 1024)",
    },
    "SCL_1024_L8": {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0],
        "bler": [0.2386, 4.721e-2, 9.128e-3, 1.784e-3, 2.882e-4],
        "source": "SCL_1024.py 5-seed average, L=8",
    },
    "CASCL_1024_L8": {
        "snr": [1.0, 1.5, 2.0, 2.5],
        "bler": [0.3976, 0.07130, 4.088e-3, 9.65e-5],
        "source": "myResult_1024.zip:CASCL_L8.dat (first block)",
    },
    "CASCL_1024_L32": {
        "snr": [1.0, 1.5, 2.0, 2.2],
        "bler": [0.2435, 0.02700, 7.067e-4, 1.112e-4],
        "source": "myResult_1024.zip:CASCL_L32.dat (seed 1825)",
    },
}

# Third-party oracle ("Po-Chung") curves the reference plots for validation.
PO_CHUNG = {
    "SCL_128_L8": {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0, 3.5],
        "bler": [0.266, 0.121, 0.0546, 0.0227, 0.00993, 0.00394],
        "source": "plot_SCL.py:66-70",
    },
    "SCL_1024_L8": {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0],
        "bler": [0.231, 0.0551, 0.00785, 0.0017, 0.00032],
        "source": "SCL_1024.py:74-78",
    },
}

# Reference SCL BLER for every L (list-monotonicity A/B data; plot_SCL.py /
# SCL_1024.py tables, see BASELINE.md).
REFERENCE_SCL_BY_L = {
    128: {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0, 3.5],
        2: [0.3182, 0.1554, 0.0791, 0.02930, 0.01076, 3.66e-3],
        4: [0.2599, 0.1338, 0.0622, 0.02439, 9.78e-3, 3.26e-3],
        8: [0.2361, 0.1237, 0.0552, 0.02405, 8.86e-3, 3.34e-3],
        16: [0.2351, 0.1218, 0.0546, 0.02322, 8.95e-3, 3.27e-3],
        32: [0.2244, 0.1241, 0.0558, 0.02324, 9.43e-3, 3.46e-3],
    },
    1024: {
        "snr": [1.0, 1.5, 2.0, 2.5, 3.0],
        2: [0.4614, 0.1285, 2.013e-2, 2.604e-3, 2.782e-4],
        4: [0.3231, 7.291e-2, 9.504e-3, 1.816e-3, 2.794e-4],
        8: [0.2386, 4.721e-2, 9.128e-3, 1.784e-3, 2.882e-4],
        16: [0.1998, 3.767e-2, 8.032e-3, 1.688e-3, 2.769e-4],
        32: [0.1750, 3.664e-2, 8.333e-3, 2.017e-3, 2.889e-4],
    },
}


def plot_results(
    records: Iterable[dict],
    out_path: str,
    title: Optional[str] = None,
    overlay: bool = True,
):
    """records: dicts with preset/snr_db/bler (PointResult.to_json format).
    Writes a log-BLER PNG overlaying the reference tables.  matplotlib is
    imported here only: importing the port does not need it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    by_preset: dict[str, list] = {}
    for r in records:
        by_preset.setdefault(r["preset"], []).append((r["snr_db"], r["bler"]))

    fig, ax = plt.subplots(figsize=(7, 5))
    for name, pts in sorted(by_preset.items()):
        pts.sort()
        ax.semilogy(
            [p[0] for p in pts], [max(p[1], 1e-12) for p in pts],
            "o-", label=f"{name} (this work)",
        )
        if overlay and name in REFERENCE_BLER:
            ref = REFERENCE_BLER[name]
            ax.semilogy(ref["snr"], ref["bler"], "k--x", alpha=0.6,
                        label=f"{name} (C reference)")
        if overlay and name in PO_CHUNG:
            pc = PO_CHUNG[name]
            ax.semilogy(pc["snr"], pc["bler"], "r:.", alpha=0.6,
                        label=f"{name} (Po-Chung)")
    ax.set_xlabel("Eb/N0 (dB)")
    ax.set_ylabel("BLER")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=140)
    plt.close(fig)
    return out_path


def load_records(paths: Iterable[str]) -> list[dict]:
    out = []
    for p in paths:
        with open(p) as f:
            data = json.load(f)
        out.extend(data if isinstance(data, list) else [data])
    return out
