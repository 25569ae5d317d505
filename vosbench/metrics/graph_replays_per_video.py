"""graph_replays_per_video: chunk programs the engine ran per video in the
window (InferenceEngine.replays, on the card one CUDA graph replay each)."""


def read(run):
    if run.kind != "stream" or not run.counts.get("videos"):
        return None
    return run.counts["replays"] / run.counts["videos"]
