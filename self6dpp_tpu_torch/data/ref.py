"""Per-dataset metadata: objects, id maps, diameters, intrinsics, frame
size, symmetric objects, model paths (DatasetMeta, DATASETS, get_meta), and
the BOP models_info symmetries. Host code, copied from
self6dpp_tpu/data/ref.py."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DatasetMeta:
    name: str
    objects: tuple[str, ...]
    id2obj: dict[int, str]
    diameters: tuple[float, ...]          # metres
    width: int
    height: int
    camera_matrix: np.ndarray
    znear: float = 0.25
    zfar: float = 6.0
    sym_objects: tuple[str, ...] = ()     # objects evaluated with ADD-S
    model_dir: str = "models"

    @property
    def obj2id(self) -> dict[str, int]:
        return {v: k for k, v in self.id2obj.items()}

    @property
    def num_objects(self) -> int:
        return len(self.objects)

    def obj_index(self, name: str) -> int:
        return self.objects.index(name)

    def diameter(self, name: str) -> float:
        return self.diameters[self.obj_index(name)]

    def is_sym(self, name: str) -> bool:
        return name in self.sym_objects

    def model_path(self, root: str, name: str) -> str:
        return os.path.join(root, self.name, self.model_dir,
                            f"obj_{self.obj2id[name]:06d}.ply")


_LM_OBJECTS = ("ape", "benchvise", "bowl", "camera", "can", "cat", "cup",
               "driller", "duck", "eggbox", "glue", "holepuncher", "iron",
               "lamp", "phone")
_LM_DIAMETERS = (0.102099, 0.247506, 0.167355, 0.172492, 0.201404, 0.154546,
                 0.124264, 0.261472, 0.108999, 0.164628, 0.175889, 0.145543,
                 0.278078, 0.282601, 0.212358)
_LM_K = np.array([[572.4114, 0, 325.2611],
                  [0, 573.57043, 242.04899],
                  [0, 0, 1]], dtype=np.float32)

# the 13 objects of the standard LM benchmark (no bowl/cup)
_LM13 = tuple(o for o in _LM_OBJECTS if o not in ("bowl", "cup"))
_LM13_DIAMS = tuple(d for o, d in zip(_LM_OBJECTS, _LM_DIAMETERS)
                    if o not in ("bowl", "cup"))

_LMO_OBJECTS = ("ape", "can", "cat", "driller", "duck", "eggbox", "glue",
                "holepuncher")
_LMO_DIAMS = tuple(_LM_DIAMETERS[_LM_OBJECTS.index(o)] for o in _LMO_OBJECTS)

_YCBV_OBJECTS = (
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser", "024_bowl",
    "025_mug", "035_power_drill", "036_wood_block", "037_scissors",
    "040_large_marker", "051_large_clamp", "052_extra_large_clamp",
    "061_foam_brick")
_YCBV_DIAMS = (0.172063, 0.269573, 0.198377, 0.120543, 0.196463, 0.089797,
               0.142543, 0.114053, 0.129540, 0.197796, 0.259534, 0.259566,
               0.161922, 0.124868, 0.226170, 0.237717, 0.203600, 0.121396,
               0.174618, 0.217249, 0.102903)
_YCBV_K = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109],
                    [0, 0, 1]], dtype=np.float32)

_HB_K = np.array([[537.4799, 0, 318.8965], [0, 536.1447, 238.3781],
                  [0, 0, 1]], dtype=np.float32)

# HomebrewedDB (ref/hb.py:30-85): real object names and diameters (mm/1000)
_HB_OBJECTS = (
    "01_bear", "02_benchvise", "03_round_car", "04_thin_cow", "05_fat_cow",
    "06_mug", "07_driller", "08_green_rabbit", "09_holepuncher", "10", "11",
    "12", "13", "14", "15", "16", "17", "18_jaffa_cakes_box", "19_minions",
    "20_color_dog", "21_phone", "22_rhinoceros", "23_dog", "24", "25_car",
    "26_motorcycle", "27_high_heels", "28_stegosaurus", "29_tea_box",
    "30_triceratops", "31_toy_baby", "32_car", "33_yellow_rabbit")
_HB_DIAMETERS = tuple(d / 1000.0 for d in (
    232.572, 257.407, 166.500, 179.029, 205.401,
    121.408, 263.718, 186.813, 166.572, 180.804,
    238.514, 156.887, 145.339, 243.733, 113.032,
    101.588, 132.771, 211.134, 185.582, 244.828,
    212.603, 190.203, 233.857, 252.263, 202.905,
    183.794, 264.442, 477.464, 198.004, 416.202,
    157.985, 201.759, 187.233))
# the 2 LM-overlap objects Self6D++ evaluates on HB (benchvise, driller)
# plus the phone; bop19 test split uses a Kinect with this K


DATASETS: dict[str, DatasetMeta] = {
    "lm_full": DatasetMeta(
        name="lm", objects=_LM_OBJECTS,
        id2obj={i + 1: o for i, o in enumerate(_LM_OBJECTS)},
        diameters=_LM_DIAMETERS, width=640, height=480,
        camera_matrix=_LM_K, sym_objects=("eggbox", "glue", "bowl", "cup")),
    "lm": DatasetMeta(
        name="lm", objects=_LM13,
        id2obj={_LM_OBJECTS.index(o) + 1: o for o in _LM13},
        diameters=_LM13_DIAMS, width=640, height=480,
        camera_matrix=_LM_K, sym_objects=("eggbox", "glue")),
    "lmo": DatasetMeta(
        name="lmo", objects=_LMO_OBJECTS,
        id2obj={_LM_OBJECTS.index(o) + 1: o for o in _LMO_OBJECTS},
        diameters=_LMO_DIAMS, width=640, height=480,
        camera_matrix=_LM_K, sym_objects=("eggbox", "glue")),
    "ycbv": DatasetMeta(
        name="ycbv", objects=_YCBV_OBJECTS,
        id2obj={i + 1: o for i, o in enumerate(_YCBV_OBJECTS)},
        diameters=_YCBV_DIAMS, width=640, height=480,
        camera_matrix=_YCBV_K, znear=0.25, zfar=6.0,
        sym_objects=("024_bowl", "036_wood_block", "051_large_clamp",
                     "052_extra_large_clamp", "061_foam_brick")),
    # 2-object synthetic dataset written by data/synthetic_bop.py —
    # used by smoke/integration runs when no real BOP data is mounted
    "synthetic": DatasetMeta(
        name="lm", objects=("ape", "can"),
        id2obj={1: "ape", 2: "can"},
        diameters=(0.21, 0.14), width=160, height=120,
        camera_matrix=np.array([[160.0, 0, 80], [0, 160.0, 60], [0, 0, 1]],
                               dtype=np.float32)),
    "hb": DatasetMeta(
        name="hb", objects=_HB_OBJECTS,
        id2obj={i + 1: o for i, o in enumerate(_HB_OBJECTS)},
        diameters=_HB_DIAMETERS,
        width=640, height=480, camera_matrix=_HB_K),
}


def get_meta(name: str) -> DatasetMeta:
    key = name.split("_")[0] if name not in DATASETS else name
    if name in DATASETS:
        return DATASETS[name]
    if key in DATASETS:
        return DATASETS[key]
    raise KeyError(f"unknown dataset: {name}")


def load_models_info(models_info_path: str) -> dict:
    """BOP models_info.json: per-object diameter, extents, symmetries (mm)."""
    with open(models_info_path) as f:
        return json.load(f)


def sym_rotations_from_info(info: dict, max_sym: int = 32,
                            n_cont: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """Build a padded (S, 3, 3) rotation set from BOP symmetry annotations
    (identity in slot 0; continuous symmetries discretized to n_cont steps).
    Reference: lib/pysixd misc.get_symmetry_transformations usage."""
    rots = [np.eye(3, dtype=np.float32)]
    for sd in info.get("symmetries_discrete", []):
        m = np.asarray(sd, dtype=np.float32).reshape(4, 4)
        rots.append(m[:3, :3])
    for sc in info.get("symmetries_continuous", []):
        axis = np.asarray(sc["axis"], dtype=np.float32)
        axis = axis / np.linalg.norm(axis)
        for i in range(1, n_cont):
            ang = 2 * np.pi * i / n_cont
            K = np.array([[0, -axis[2], axis[1]],
                          [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]], dtype=np.float32)
            rots.append(np.eye(3, dtype=np.float32) + np.sin(ang) * K
                        + (1 - np.cos(ang)) * K @ K)
    rots = rots[:max_sym]
    valid = np.zeros(max_sym, dtype=bool)
    valid[: len(rots)] = True
    out = np.broadcast_to(np.eye(3, dtype=np.float32), (max_sym, 3, 3)).copy()
    out[: len(rots)] = np.stack(rots)
    return out, valid
