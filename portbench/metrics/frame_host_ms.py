"""frame_host_ms (ms): host time a frame spends outside Renderer.render:
the animation step and update_scene_data, the snapshot and the hand-off to
the saver, from the benchmark's spans (each ending in a sync), over the
traced run's frames outside its profiled sub-window."""

HOST_SPANS = ("scene_update", "update", "snapshot", "handoff")


def read(run):
    if run.kind != "video":
        return None
    frames = {f for name, _, _, f in run.spans if name == "render"}
    if not frames:
        return None
    total = sum(end - start for name, start, end, f in run.spans
                if name in HOST_SPANS and f in frames)
    return total / len(frames) * 1e3
