"""Class-name metadata loading for visualisation and the demos (copy of
``vtm/utils/class_names.py``).

Functional parity target: slowfast/utils/misc.py::get_class_names
(:433-502): {"class": id} json -> ordered name list, optional
parent->children-id map, optional subset-id list.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

from vtm_torch.utils.pathmgr import pathmgr


def get_class_names(path: str, parent_path: Optional[str] = None,
                    subset_path: Optional[str] = None) -> Optional[Tuple]:
    """(class_names, class_parent, subset_ids); None on load failure
    (the reference prints and returns None)."""
    try:
        with pathmgr.open(path, "r") as f:
            class2idx = json.load(f)
    except Exception as err:
        print(f"Fail to load file from {path} with error {err}")
        return None

    class_names = [None] * (max(class2idx.values()) + 1)
    for name, idx in class2idx.items():
        class_names[idx] = name

    class_parent = None
    if parent_path:
        try:
            with pathmgr.open(parent_path, "r") as f:
                d_parent = json.load(f)
        except EnvironmentError as err:
            print(f"Fail to load file from {parent_path} with error {err}")
            return None
        class_parent = {
            parent: [
                class2idx[c] for c in children
                if class2idx.get(c) is not None
            ]
            for parent, children in d_parent.items()
        }

    subset_ids = None
    if subset_path:
        try:
            with pathmgr.open(subset_path, "r") as f:
                subset = f.read().split("\n")
        except EnvironmentError as err:
            print(f"Fail to load file from {subset_path} with error {err}")
            return None
        subset_ids = [
            class2idx[name] for name in subset
            if class2idx.get(name) is not None
        ]

    return class_names, class_parent, subset_ids
