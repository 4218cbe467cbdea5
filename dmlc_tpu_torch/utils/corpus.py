"""Synthetic evaluation corpus: the reference's fixture-dataset shape.

The reference ships ``test_files/imagenet_1k/train/<synset>/<one JPEG>`` (one
image per each of 1,000 classes) plus ``synset_words.txt`` mapping synset ids
to labels (src/services.rs:170-184, 485-490). That corpus is not
redistributable here, so this module *generates* one with the same layout:
deterministic random JPEGs, one directory per synthetic synset. It powers the
end-to-end (JPEG -> top-1) bench mode and any test that wants a real
decode-from-disk path without shipping binary fixtures.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np


def write_synset_words(path: str | Path, n_classes: int) -> Path:
    """``synset_words.txt`` with synthetic ids n00000000..: one per class."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(f"n{i:08d} synthetic class {i}\n" for i in range(n_classes)))
    return path


def _reusable(
    root: Path, n_classes: int, images_per_class: int, kind: str
) -> tuple[Path, Path] | None:
    """Existing corpora with the right shape AND kind are reused, not
    regenerated. Reuse only when BOTH dimensions match: a corpus with fewer
    images per class than requested would silently shrink whatever
    measurement asked for this shape. The kind marker keeps the two
    generators from adopting each other's output at a shared root — an
    i.i.d. corpus reused by generate_learnable would cap training at
    chance with no hint why (a pre-marker corpus counts as "iid", which is
    what every pre-marker corpus was)."""
    data_dir = root / "train"
    synset_path = root / "synset_words.txt"
    if not (synset_path.exists() and data_dir.exists()):
        return None
    marker = root / ".corpus_kind"
    existing_kind = marker.read_text().strip() if marker.exists() else "iid"
    if existing_kind != kind:
        return None
    dirs = [d for d in data_dir.iterdir() if d.is_dir()]
    if len(dirs) >= n_classes and all(
        sum(1 for f in d.iterdir() if f.is_file()) >= images_per_class
        for d in dirs[:n_classes]
    ):
        return data_dir, synset_path
    return None


def _fresh_tree(root: Path) -> None:
    """Remove a non-reusable corpus before regenerating. The generators
    write only the first n_classes dirs / images_per_class files; without
    this wipe, leftover class dirs and higher-index images from a previous
    different-kind (or bigger) corpus at the same root would survive under
    the new ``.corpus_kind`` marker, and any consumer that globs class
    dirs would see mixed-kind data."""
    shutil.rmtree(root / "train", ignore_errors=True)
    (root / ".corpus_kind").unlink(missing_ok=True)


def generate_learnable(
    root: str | Path,
    n_classes: int = 40,
    images_per_class: int = 8,
    size: int = 32,
    seed: int = 0,
    noise: int = 28,
    quality: int = 90,
) -> tuple[Path, Path]:
    """A corpus a model can actually LEARN: every image of class ``i`` is a
    class-specific low-frequency pattern (deterministic in ``i``) plus
    per-image noise, JPEG-encoded. ``img0.jpg`` in each class directory is
    the held-out sample the cluster's predict path evaluates on
    (ops/preprocess.class_image_path picks the first file) — train on
    ``img1..`` and the jobs report's accuracy measures generalization to
    an unseen image of each class, not memorization.

    ``generate`` (below) keeps the reference fixture's *shape* with
    unlearnable i.i.d. images; this variant exists for the train→publish→
    hot-swap→accuracy loop (reference ships pretrained checkpoints and
    reports live accuracy, services.rs:74-80,139-144 — here the framework
    trains the checkpoint itself). Same layout, same reuse rule.
    """
    from PIL import Image

    root = Path(root)
    reuse = _reusable(root, n_classes, images_per_class, "learnable")
    if reuse is not None:
        return reuse
    _fresh_tree(root)

    data_dir = root / "train"
    synset_path = write_synset_words(root / "synset_words.txt", n_classes)
    rng = np.random.default_rng(seed)
    low = 4  # class signature lives in the lowest frequencies
    for i in range(n_classes):
        d = data_dir / f"n{i:08d}"
        d.mkdir(parents=True, exist_ok=True)
        sig_rng = np.random.default_rng(10_000 + i)  # per-class, not per-run
        base = Image.fromarray(
            sig_rng.integers(40, 216, (low, low, 3), np.uint8)
        ).resize((size, size), Image.BILINEAR)
        base = np.asarray(base, dtype=np.int16)
        for j in range(images_per_class):
            jitter = rng.integers(-noise, noise + 1, (size, size, 3), np.int16)
            im = np.clip(base + jitter, 0, 255).astype(np.uint8)
            Image.fromarray(im).save(d / f"img{j}.jpg", quality=quality)
    (root / ".corpus_kind").write_text("learnable\n")
    return data_dir, synset_path


def generate(
    root: str | Path,
    n_classes: int = 100,
    images_per_class: int = 1,
    size: int = 256,
    seed: int = 0,
    quality: int = 90,
) -> tuple[Path, Path]:
    """Create the corpus under ``root``; returns (data_dir, synset_path).

    Layout: ``root/train/n{i:08d}/img{j}.jpg`` + ``root/synset_words.txt``.
    Images are smooth random fields (not pure noise) so JPEG encode/decode
    behaves like photographs rather than degenerate high-entropy blocks.
    Existing corpora with the right shape and kind are reused (see
    ``_reusable``), not regenerated.
    """
    from PIL import Image

    root = Path(root)
    reuse = _reusable(root, n_classes, images_per_class, "iid")
    if reuse is not None:
        return reuse
    _fresh_tree(root)

    data_dir = root / "train"
    synset_path = write_synset_words(root / "synset_words.txt", n_classes)
    rng = np.random.default_rng(seed)
    low = max(8, size // 8)
    for i in range(n_classes):
        d = data_dir / f"n{i:08d}"
        d.mkdir(parents=True, exist_ok=True)
        for j in range(images_per_class):
            # Low-frequency field upsampled to full size: photograph-like
            # JPEG statistics at ~100x the encode speed of per-pixel noise.
            base = rng.integers(0, 256, (low, low, 3), np.uint8)
            im = Image.fromarray(base).resize((size, size), Image.BILINEAR)
            im.save(d / f"img{j}.jpg", quality=quality)
    (root / ".corpus_kind").write_text("iid\n")
    return data_dir, synset_path
