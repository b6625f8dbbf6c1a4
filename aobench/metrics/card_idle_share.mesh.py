"""``card_idle_share.mesh``: the share of the cards' time in the profiled
sub-window in which they ran nothing, in %: 1 - the sum over the cards of
each card's own busy seconds (``busy_s_by_card``) over the cards used
(``device.count``) times the window.  A card with no operation counts as
idle; an idle card does not hide behind a busy one, as in the union that
``idle_share.frame`` reads."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("busy_s_by_card") or not prof["window_s"] > 0:
        return None
    cards = rec["device"]["count"]
    return 100.0 * (1.0 - sum(prof["busy_s_by_card"].values())
                    / (cards * prof["window_s"]))
