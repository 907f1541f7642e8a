"""Project manager: the headless counterpart of the reference's project
GUI (PyTorch port of ``pipeline/project.py``). A project directory holds
``project_config.json`` and the movie's scene CSV, whose extra columns
carry per-scene Engine / Infill / Convergence overrides; a scene can be
split at a frame, renumbering the scenes and renaming their files; ``run``
runs the movie pipeline over the project, resumable. The files are the
JAX package's, byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

from metric_depth_video_toolbox_tpu_torch.pipeline import scenes as scene_mod

CONFIG_NAME = "project_config.json"

DEFAULT_CONFIG = {
    # reference defaults: engine=da3, infill=inspatio_world
    # (MDVT_gui.py:164-170); ours defaults to the self-contained engines
    "depth_engine": "vda",
    "infill_engine": "basic",
    "max_depth": 100.0,
    "max_scene_frames": 1500,
    "xfov": None,
    "batch_size": 8,
}


@dataclasses.dataclass
class Project:
    root: str
    config: dict

    @property
    def scene_csv(self):
        name = os.path.splitext(
            os.path.basename(self.config["color_video"]))[0]
        return os.path.join(self.root, name + "-Scenes.csv")

    def scenes(self):
        return scene_mod.read_scene_csv(self.scene_csv)

    def save_config(self):
        with open(os.path.join(self.root, CONFIG_NAME), "w",
                  encoding="utf-8") as f:
            json.dump(self.config, f, indent=2)

    def save_scenes(self, scenes):
        scene_mod.write_scene_csv(self.scene_csv, scenes)


def create_project(root, color_video, **overrides):
    """Create a project dir with config + detected scene table
    (MDVT_gui.py:129-172 semantics)."""
    os.makedirs(root, exist_ok=True)
    config = dict(DEFAULT_CONFIG)
    config["color_video"] = os.path.abspath(color_video)
    config.update(overrides)
    proj = Project(root=root, config=config)
    proj.save_config()
    if not os.path.exists(proj.scene_csv):
        scene_mod.write_scene_csv(proj.scene_csv,
                                  scene_mod.detect_scenes(color_video))
    return proj


def open_project(root):
    with open(os.path.join(root, CONFIG_NAME), encoding="utf-8") as f:
        config = json.load(f)
    return Project(root=root, config=config)


def set_scene_override(proj: Project, scene_number, column, value):
    """Per-scene Engine / Infill / Convergence override
    (the GUI's scene-table edit; movie orchestrator consumes these,
    movie_2_3D.py:264-267,326-328)."""
    scenes = proj.scenes()
    hit = False
    for s in scenes:
        if int(s["Scene Number"]) == int(scene_number):
            s[column] = value
            hit = True
    if not hit:
        raise KeyError(f"scene {scene_number} not found")
    proj.save_scenes(scenes)
    return scenes


def split_scene(proj: Project, scene_number, at_frame):
    """Split one scene at an absolute frame, renumber consecutively, and
    rename existing per-scene artifact files to match the new numbering
    (gui_frontend_movie_2_3d.py:105-174)."""
    scenes = proj.scenes()
    out = []
    mapping = {}  # old number -> new number (for artifact renames)
    new_no = 1
    for s in scenes:
        old_no = int(s["Scene Number"])
        sf, ef = int(s["Start Frame"]), int(s["End Frame"])
        if old_no == int(scene_number):
            if not (sf < at_frame <= ef):
                raise ValueError(
                    f"split frame {at_frame} outside scene ({sf}..{ef})")
            parts = scene_mod.split_scenes(
                [dict(s, **{"End Frame": str(at_frame - 1)})], 10**9) + \
                scene_mod.split_scenes(
                    [dict(s, **{"Start Frame": str(at_frame)})], 10**9)
            for p in parts:
                p["Scene Number"] = str(new_no)
                out.append(p)
                new_no += 1
            mapping[old_no] = None  # artifacts for split scene are stale
        else:
            mapping[old_no] = new_no
            s = dict(s)
            s["Scene Number"] = str(new_no)
            out.append(s)
            new_no += 1

    # rename artifacts scene_<old>.* -> scene_<new>.* (two-phase via tmp
    # names to avoid collisions)
    renames = []
    for old_no, new_no2 in mapping.items():
        if new_no2 is None or old_no == new_no2:
            continue
        for fname in os.listdir(proj.root):
            prefix = f"scene_{old_no}.mkv"
            if fname.startswith(prefix):
                suffix = fname[len(prefix):]
                renames.append((fname, f"scene_{new_no2}.mkv{suffix}"))
    for src, dst in renames:
        shutil.move(os.path.join(proj.root, src),
                    os.path.join(proj.root, src + ".renaming"))
    for src, dst in renames:
        shutil.move(os.path.join(proj.root, src + ".renaming"),
                    os.path.join(proj.root, dst))

    proj.save_scenes(out)
    return out


def run_project(proj: Project, end_scene=-1, steps=None, device=None):
    """Run the movie pipeline for the project (the GUI's 'run' button;
    resume-by-existence, so re-running continues where it stopped)."""
    from metric_depth_video_toolbox_tpu_torch.pipeline import movie
    cfg = proj.config
    return movie.movie_to_3d(
        cfg["color_video"], output_dir=proj.root,
        engine=cfg.get("depth_engine", "vda"),
        infill_engine=cfg.get("infill_engine", "basic"),
        xfov=cfg.get("xfov"), max_depth=cfg.get("max_depth", 100.0),
        max_scene_frames=cfg.get("max_scene_frames", 1500),
        scene_file=proj.scene_csv, end_scene=end_scene,
        batch_size=cfg.get("batch_size", 8), device=device)


def status(proj: Project):
    """Per-scene progress table (what the GUI's scene table displays)."""
    from metric_depth_video_toolbox_tpu_torch.pipeline import movie
    scenes = movie.plan_scene_files(proj.scenes(), proj.root)
    rows = []
    for s in scenes:
        rows.append({
            "scene": s["Scene Number"],
            "frames": s["Length (frames)"],
            "engine": s.get("Engine", "") or proj.config.get(
                "depth_engine", "vda"),
            "clip": os.path.exists(s["scene_video_file"]),
            "depth": os.path.exists(s["depth_video_file"]),
            "mask": os.path.exists(s["mask_video_file"]),
            "sbs": os.path.exists(s["sbs"]),
            "infilled": os.path.exists(s["infilled"]),
        })
    return rows
