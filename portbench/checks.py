"""The comparison that decides ``correct``.

Every number compared is a count with the limit 0: the classify is exact
integer work, so one packet answered otherwise than the reference says is a
fault.  ``packets_compared`` must reach 1, so a run that compared nothing
is not correct either.
"""
from __future__ import annotations

from portbench.reference import REQUEST

__all__ = ["compare", "passed", "text"]


def compare(pool: list, expected: list, answers: list,
            unanswered: int) -> dict:
    """``answers``: (pool index, rslt, codes, svm_acc) of each answer kept,
    the arrays as the program returned them (codes as int32 bits; codes and
    svm_acc None where the entry returns ``rslt`` alone, and then every
    passthrough packet counts as changed, since none can be shown intact);
    ``expected[i]``: the reference's ``rslt`` for ``pool[i]``."""
    wrong = changed = compared = 0
    for i, rslt, codes, acc in answers:
        p, want = pool[i], expected[i]
        req = p.ptype == REQUEST
        wrong += int((rslt[req] != want[req]).sum())
        fwd = ~req
        if codes is None or acc is None:
            changed += int(fwd.sum())
        else:
            changed += int(((rslt[fwd] != p.rslt[fwd])
                            | (codes[fwd] != p.codes[fwd]).any(axis=1)
                            | (acc[fwd] != p.acc[fwd]).any(axis=1)).sum())
        compared += rslt.size
    return {"wrong_rslt": {"value": wrong, "max": 0},
            "forward_changed": {"value": changed, "max": 0},
            "unanswered": {"value": int(unanswered), "max": 0},
            "packets_compared": {"value": compared, "min": 1}}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["max"] if "max" in c else c["value"] >= c["min"]
               for c in checks.values())


def text(checks: dict) -> list[str]:
    """One line a number compared, beside its limit."""
    return [f"{name} {c['value']} (limit: "
            + (f"at most {c['max']})" if "max" in c else f"at least {c['min']})")
            for name, c in checks.items()]
