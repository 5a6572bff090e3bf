"""Model FLOPs a unit (no recompute; ``bench/flops.py``) at the window's unit
rate past the traced stretch, over the bf16 peak of every chip the cell
uses, %. None on a card whose peak ``bench/flops.py`` does not list."""


def read(trace):
    i = trace.info
    if not i.get("units_per_s") or not i.get("peak_flops"):
        return None  # no unit ran past the traced stretch, or the peak is unknown
    return 100.0 * i["flops_per_unit"] * i["units_per_s"] / (i["peak_flops"] * i["chips"])
