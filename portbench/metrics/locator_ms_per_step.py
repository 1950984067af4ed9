"""Self time of ``LocatorTool._capture_stack`` a window step; nothing to
read in a session without the locator."""


def read(run):
    if run.spans is None or not run.steps or "locator" not in run.tools:
        return None
    return run.spans.get("locator stack capture", 0.0) / run.steps * 1e3
