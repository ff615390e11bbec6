"""Three-tier configuration system for SAFE analyses.

Semantics follow the reference config stack (safepy/safe.py:116-235 and
safepy/safe_default.ini): package defaults from ``safe_default.ini`` shipped next to
this module, overlaid by an optional user INI, overlaid again by per-call kwargs on the
pipeline methods. Every setting is a plain mutable attribute on the ``SAFE`` facade, so
the precedence chain is defaults -> INI -> attribute assignment -> call-site kwargs.

Implementation here is dataclass-backed instead of ad-hoc attributes, but the facade
(`safepy_tpu.safe.SAFE`) exposes the exact same attribute names as the reference.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from typing import Optional

_INI_COMMENT_KW = dict(
    allow_no_value=True,
    comment_prefixes=("#", ";", "{"),
    inline_comment_prefixes="#",
)


@dataclasses.dataclass
class SafeConfig:
    """All SAFE settings with their package defaults.

    Field names match the instance attributes of the reference SAFE class
    (safepy/safe.py:57-107); INI option names are mapped in :func:`read_config`.
    """

    path_to_safe_data: Optional[str] = None
    path_to_network_file: Optional[str] = None
    path_to_attribute_file: Optional[str] = None
    view_name: Optional[str] = None

    node_key_attribute: str = "label_orf"
    layout_algorithm: str = "spring_embedded"  # spring_embedded|kamada_kawai|spring_device

    attribute_sign: str = "both"  # highest | lowest | both

    node_distance_metric: str = "shortpath_weighted_layout"
    neighborhood_radius_type: Optional[str] = None
    neighborhood_radius: Optional[float] = None

    background: str = "attribute_file"  # attribute_file | network
    num_permutations: int = 1000
    multiple_testing: bool = False
    neighborhood_score_type: str = "sum"  # sum | z-score
    enrichment_type: str = "auto"  # auto | hypergeometric | randomization
    enrichment_threshold: float = 0.05
    enrichment_max_log10: float = 16
    attribute_enrichment_min_size: int = 10
    random_seed: Optional[int] = None

    attribute_unimodality_metric: str = "connectivity"
    attribute_distance_metric: str = "jaccard"
    attribute_distance_threshold: float = 0.75

    output_dir: str = ""


def default_ini_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "safe_default.ini")


def read_config(path_to_ini_file: str = "",
                path_to_safe_data: Optional[str] = None) -> tuple[SafeConfig, configparser.SectionProxy]:
    """Load layered INI config: package defaults overlaid by an optional user INI.

    Returns the populated :class:`SafeConfig` plus the raw DEFAULT section (used to
    restore defaults when validation fails, mirroring safepy/safe.py:190-235).
    """

    loc = os.path.dirname(os.path.abspath(__file__))

    default_config = configparser.ConfigParser(**_INI_COMMENT_KW)
    with open(default_ini_path(), "r") as f:
        default_config.read_file(f)
    defaults = default_config["DEFAULT"]

    config = configparser.ConfigParser(defaults=defaults, **_INI_COMMENT_KW)
    if path_to_ini_file:
        config.read(path_to_ini_file)

    for section in ("Input files", "Analysis parameters"):
        if section not in config:
            config[section] = {}

    cfg = SafeConfig()

    if path_to_safe_data is None:
        path_to_safe_data = config.get("Input files", "safe_data") or None
    cfg.path_to_safe_data = path_to_safe_data

    network_file = config.get("Input files", "networkfile")
    attribute_file = config.get("Input files", "annotationfile")

    if cfg.path_to_safe_data is not None:
        if not cfg.path_to_safe_data.endswith("/"):
            raise AssertionError(
                "path_to_safe_data should end with '/', else os.path.join may not "
                "provide the desired output.")
        cfg.path_to_network_file = os.path.join(cfg.path_to_safe_data, network_file)
        cfg.path_to_attribute_file = os.path.join(cfg.path_to_safe_data, attribute_file)
    else:
        cfg.path_to_network_file = network_file
        cfg.path_to_attribute_file = attribute_file

    cfg.attribute_sign = config.get("Input files", "annotationsign")

    # The reference declares layoutAlgorithm in its INI but never consumes it
    # (safe_default.ini:9); here it selects the txt-loader layout engine.
    layout = config.get("Input files", "layoutalgorithm", fallback="") or ""
    cfg.layout_algorithm = layout.strip() or "spring_embedded"

    cfg.background = config.get("Analysis parameters", "background")
    cfg.node_distance_metric = config.get("Analysis parameters", "nodeDistanceType")
    cfg.neighborhood_radius_type = config.get("Analysis parameters", "neighborhoodRadiusType")
    cfg.neighborhood_radius = float(config.get("Analysis parameters", "neighborhoodRadius"))

    raw_seed = config.get("Analysis parameters", "randomSeed")
    try:
        cfg.random_seed = int(raw_seed)
    except (ValueError, TypeError):
        cfg.random_seed = None

    cfg.attribute_unimodality_metric = config.get("Analysis parameters", "unimodalityType")
    cfg.attribute_distance_metric = config.get("Analysis parameters", "groupDistanceType")
    cfg.attribute_distance_threshold = float(config.get("Analysis parameters", "groupDistanceThreshold"))

    cfg.output_dir = os.path.dirname(path_to_ini_file) or loc

    return cfg, defaults


def validate_config(obj, defaults) -> None:
    """Enum + range checks on the live settings of ``obj`` (a SAFE instance).

    On failure the offending attribute is restored to its default AND a ValueError is
    raised — identical contract to the reference validator (safepy/safe.py:190-235),
    which every pipeline stage re-runs before touching data.
    """

    if obj.background not in ("attribute_file", "network"):
        bad = obj.background
        obj.background = defaults.get("background")
        raise ValueError(f"{bad} is not a valid setting for background. "
                         "Valid options are: attribute_file, network.")

    if obj.node_distance_metric not in ("euclidean", "shortpath", "shortpath_weighted_layout"):
        bad = obj.node_distance_metric
        obj.node_distance_metric = defaults.get("nodedistancetype")
        raise ValueError(f"{bad} is not a valid setting for node_distance_metric. "
                         "Valid options are: euclidean, shortpath, shortpath_weighted_layout")

    if obj.attribute_sign not in ("highest", "lowest", "both"):
        bad = obj.attribute_sign
        obj.attribute_sign = defaults.get("annotationsign")
        raise ValueError(f"{bad} is not a valid setting for attribute_sign. "
                         "Valid options are: highest, lowest, both")

    if not isinstance(obj.num_permutations, int) or obj.num_permutations < 10:
        obj.num_permutations = 1000
        raise ValueError("num_permutations must be an integer equal or greater than 10.")

    if (not isinstance(obj.enrichment_threshold, float)
            or obj.enrichment_threshold <= 0 or obj.enrichment_threshold >= 1):
        obj.enrichment_threshold = 0.05
        raise ValueError("enrichment_threshold must be in the (0,1) range.")

    if not isinstance(obj.enrichment_max_log10, (int, float)):
        obj.enrichment_max_log10 = 16
        raise ValueError("enrichment_max_log10 must be a number.")

    if (not isinstance(obj.attribute_enrichment_min_size, int)
            or obj.attribute_enrichment_min_size < 2):
        obj.attribute_enrichment_min_size = 10
        raise ValueError("attribute_enrichment_min_size must be an integer equal or greater than 2.")

    if (not isinstance(obj.attribute_distance_threshold, float)
            or obj.attribute_distance_threshold <= 0 or obj.attribute_distance_threshold >= 1):
        obj.attribute_distance_threshold = 0.75
        raise ValueError("attribute_distance_threshold must be a float number in the (0,1) range.")

    if getattr(obj, "cluster_engine", "auto") not in ("auto", "gemm", "scipy"):
        bad = obj.cluster_engine
        obj.cluster_engine = "auto"
        raise ValueError(f"{bad} is not a valid setting for cluster_engine. "
                         "Valid options are: auto, gemm, scipy.")
