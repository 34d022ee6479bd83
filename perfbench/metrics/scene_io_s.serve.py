"""Mean host seconds a scene spends reading the GeoTIFF and writing the
class map, from the predictor's own scene records (``read_s`` +
``write_s``) of the window's scenes."""


def read(run):
    scenes = [s for s in run.record.get("scenes", []) if "read_s" in s and "write_s" in s]
    return sum(s["read_s"] + s["write_s"] for s in scenes) / len(scenes) if scenes else None
