"""Explored decode chunks over all routed decode chunks in the window, in
percent, from the program's ``ContextRouter.stats()`` (online tuning)."""


def read(ctx):
    router = getattr(ctx, "window", {}).get("router")
    if not router:
        return None
    total = router["explores"] + router["exploits"]
    return 100.0 * router["explores"] / total if total else None
