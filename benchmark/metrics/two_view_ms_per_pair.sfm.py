"""Matching and geometry's host-clock time a pair: spans around each
``two_view_batch`` / ``two_view_sfm`` call, the device synchronized at both
ends."""


def read(obs: dict):
    s = obs["spans"].get("two_view")
    if not s:
        return None
    return 1000.0 * sum(t for t, _ in s) / sum(n for _, n in s)
