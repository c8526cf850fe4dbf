"""The slowest rank's own sweep seconds (the gather left out) over the ranks' mean."""


def read(r):
    own = r.get("driver", {}).get("rank_seconds")
    if not own or min(own) <= 0:
        return None
    return max(own) / (sum(own) / len(own))
