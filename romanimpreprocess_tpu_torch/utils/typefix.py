"""Output-schema compatibility fixes.

Equivalent of the reference's ``utils/typefix.py:7-56``, which guards
against Roman schema drift when writing L2 trees: injects the dummy
``chisq``/``dumo`` float16 fields expected by newer schemas (recording
which were dummies in ``meta.dummyfields``), coerces ``read_pattern``
to plain lists, and demotes err/variance planes to float16 when a
downstream consumer requires it.
"""

import numpy as np

from . import profiling

VAR_FIELDS = ("err", "var_poisson", "var_rnoise", "var_flat")


@profiling.span("host.typefix")
def fix(tree, demote_var_to_f16=False):
    """Normalize an L2 tree in place for schema compatibility (the span
    ``host.typefix``).

    Parameters
    ----------
    tree : dict with a ``roman`` branch.
    demote_var_to_f16 : also cast the err/var planes to float16 (the
        reference's validation-retry loop ends up doing this when the
        schema demands float16).
    """
    roman = tree["roman"] if "roman" in tree else tree
    dummyfields = []
    shape = np.asarray(roman["data"]).shape
    for field in ("chisq", "dumo"):
        if field not in roman:
            roman[field] = np.zeros(shape, dtype=np.float16)
            # the reference's 'roman.<field>' naming (typefix.py:29)
            dummyfields.append(f"roman.{field}")
    if dummyfields:
        meta = roman.setdefault("meta", {})
        # APPEND to any earlier stage's list (the reference does;
        # overwriting would silently drop prior provenance entries)
        meta["dummyfields"] = list(meta.get("dummyfields", [])) + dummyfields

    meta = roman.get("meta", {})
    exposure = meta.get("exposure", {})
    if "read_pattern" in exposure:
        exposure["read_pattern"] = [
            [int(r) for r in grp] for grp in exposure["read_pattern"]
        ]

    if demote_var_to_f16:
        for field in VAR_FIELDS:
            if field in roman:
                roman[field] = np.asarray(roman[field], dtype=np.float16)
    return tree
