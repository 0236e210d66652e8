"""Share of the traced window in which no kernel, copy or memset runs on
the card, over the traced plans (entry search + planned path), from the torch.profiler
timeline (layer `device`)."""


def read(run):
    prof = run.facts.get("profile")
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"]) if prof else None
