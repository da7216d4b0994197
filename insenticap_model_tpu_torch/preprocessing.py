"""Offline preprocessing and the image helpers of serving: the port's
``insenticap_model_tpu/preprocessing.py`` (reference preprocess.py, L1 in
SURVEY.md §1).

The serving half: image decoding, the resize bucket ladder, bucket
assignment and resize, uint8 RGB normalisation and the sentiment-word
ranking of detected concepts (reference preprocess.py:280-302). The
offline half: feature extraction (``extract_imgs_feat``: ResNet-101 on the
card, whose stem runs the max-pool kernel), caption and corpus processing,
sentiment-word mining, the vocabularies, the sentiment-image split and the
per-sentiment LMs, each writing the JAX package's JSON byte for byte (the
same code over the port's ``text`` module, whose tokens and tags are the
JAX package's).

The JAX package decodes and resizes with PIL (:50-117). The port has no
PIL, so it carries its own, to give PIL's arrays bit for bit:

* ``load_image`` / ``load_image_bytes``: JPEG through the host library
  ``csrc/imgdec.cc`` (baseline, extended-sequential and progressive
  Huffman JPEG; libjpeg's integer IDCT, fancy upsampling and colour
  tables, and libjpeg-turbo's block smoothing of an incomplete
  progression; built by ``ops/_build.load_host`` at first use) and PNG
  here (chunks and CRCs, zlib, then the row filters in the same library).
  The arrays are ``_pil_to_array``'s: "L" stays 2-D, "RGBA" drops its
  alpha, every other mode becomes RGB. What the decoders do not take
  raises ``ValueError`` naming it: lossless, hierarchical and
  arithmetic-coded JPEG, CMYK/YCCK and Adobe-RGB JPEG, 12-bit JPEG,
  interlaced PNG and 16-bit PNG. Greyscale PNG at 1, 2 and 4 bits is
  read as PIL reads it: 1 bit is mode "1" (RGB of 0 and 255), 2 and 4
  bits are "L" scaled to 0..255.
* ``resize_to_bucket``: Pillow's ``BILINEAR`` resampler
  (``libImaging/Resample.c``) in numpy: separable, the horizontal pass
  first with a uint8 round between the passes, the triangle filter widened
  by the scale when it shrinks, weights in 22-bit fixed point.

The JAX package's documented divergences from the reference hold here too:
idx2word's dedup is sorted (the reference's ``list(set(...))`` order
depends on the hash seed, preprocess.py:274-275), POS tags come from
``text.py``, and the LMs are trained by the repo's C++ ``isclm`` where
SRILM's ``ngram-count`` is absent (KenLM files are skipped with a note
where ``lmplz`` is absent). Feature stores are written in the native
format only: ``store_format="h5"`` is refused by name, as the port's
readers refuse HDF5 (the card's machine has no h5py).
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import random
import shutil
import struct
import subprocess
import zlib
from collections import Counter, defaultdict
from copy import deepcopy
from typing import Dict, List, Optional

import numpy as np
import torch

from . import text
from .data.feature_store import write_native_store
from .utils.dtypes import resolve_device, to_device

CONCEPT_POS = ("VERB", "NOUN")  # reference preprocess.py:20

# Static shape ladder of the resize policy: 448x448 plus the two 3:4
# aspects. Every extent is a multiple of 32, so the last conv map is
# (H/32, W/32); at 448x448 that is the 14x14 att grid itself.
DEFAULT_BUCKET_SHAPES = ((448, 448), (384, 512), (512, 384))


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGS = {"isc_jpeg_info": [_P, _LL, _IP, _IP, _IP, _P, _I],
         "isc_jpeg_decode": [_P, _LL, _P, _LL, _P, _I],
         "isc_png_unfilter": [_P, _LL, _P, _I, _LL, _I, _P, _I]}
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PIL refuses an image of more than twice Image.MAX_IMAGE_PIXELS (its
# DecompressionBombError); so do the decoders, before allocating anything
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)
# PNG colour type -> (channels, bit depths the port reads)
_PNG_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8,)), 6: (4, (8,))}


def _lib():
    from .ops import _build
    return _build.load_host("imgdec", _SIGS)


def _call(fn, *args):
    err = ctypes.create_string_buffer(256)
    if fn(*args, err, len(err)) != 0:
        raise ValueError(err.value.decode(errors="replace"))


def _check_pixels(h: int, w: int) -> None:
    if h * w > MAX_PIXELS:
        raise ValueError(f"image of {h}x{w} pixels exceeds the limit of "
                         f"{MAX_PIXELS} (a decompression bomb to PIL too)")


def _decode_jpeg(data: bytes) -> np.ndarray:
    lib = _lib()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _call(lib.isc_jpeg_info, data, len(data), ctypes.byref(h),
          ctypes.byref(w), ctypes.byref(c))
    _check_pixels(h.value, w.value)
    shape = (h.value, w.value) + ((3,) if c.value == 3 else ())
    out = np.empty(shape, np.uint8)
    _call(lib.isc_jpeg_decode, data, len(data), out.ctypes.data, out.size)
    return out


def _png_chunks(data: bytes):
    pos = len(_PNG_SIG)
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated file (no IEND chunk)")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + n
        if end + 4 > len(data):
            raise ValueError(f"PNG: truncated file (in a {kind!r} chunk)")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: corrupt data (CRC of a {kind!r} chunk)")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end + 4


def _unpack_bits(rows: np.ndarray, depth: int, w: int) -> np.ndarray:
    """[h, rowbytes] packed samples (big-endian within a byte) ->
    [h, w] uint8 sample values."""
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per)[:, :w]


def _decode_png(data: bytes) -> np.ndarray:
    ihdr, plte, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or len(ihdr) != 13:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              ihdr)
    if ctype not in _PNG_TYPES or comp or filt or not (w and h):
        raise ValueError(f"PNG: bad header (colour type {ctype}, size "
                         f"{w}x{h})")
    channels, depths = _PNG_TYPES[ctype]
    if depth == 16:
        raise ValueError("PNG: unsupported: 16-bit samples")
    if depth not in depths:
        raise ValueError(f"PNG: bad bit depth {depth} for colour type "
                         f"{ctype}")
    if interlace:
        raise ValueError("PNG: unsupported: interlaced (Adam7)")
    _check_pixels(h, w)
    rowbytes = (w * channels * depth + 7) // 8
    try:      # no more than the image holds, whatever the stream inflates to
        raw = zlib.decompressobj().decompress(b"".join(idat),
                                              h * (rowbytes + 1))
    except zlib.error as e:
        raise ValueError(f"PNG: corrupt image data ({e})") from None
    rows = np.empty((h, rowbytes), np.uint8)
    _call(_lib().isc_png_unfilter, raw, len(raw), rows.ctypes.data, h,
          rowbytes, max(1, channels * depth // 8))
    if depth < 8:
        rows = _unpack_bits(rows, depth, w)
    if ctype == 3:
        if plte is None or len(plte) % 3:
            raise ValueError("PNG: palette image without a valid PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        return pal[rows]
    if ctype == 0:
        if depth == 1:                  # PIL mode "1", then RGB
            return np.repeat((rows * 255)[:, :, None], 3, axis=2)
        return rows * (255 // ((1 << depth) - 1))    # "L;2", "L;4", "L"
    img = rows.reshape(h, w, channels)
    if ctype == 4:                      # "LA" -> RGB
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])       # RGB, RGBA


def load_image_bytes(data: bytes) -> np.ndarray:
    """Encoded JPEG or PNG bytes -> HWC uint8 RGB, or HW uint8 for a
    greyscale image, as the JAX package's PIL path gives them. Anything
    else, or what the decoders do not take, raises ValueError."""
    data = bytes(data)
    if data[:2] == b"\xff\xd8":
        return _decode_jpeg(data)
    if data[:8] == _PNG_SIG:
        return _decode_png(data)
    raise ValueError("not a JPEG or PNG image")


def load_image(path: str) -> np.ndarray:
    """``load_image_bytes`` of a file."""
    with open(path, "rb") as f:
        return load_image_bytes(f.read())


def to_rgb_uint8(image: np.ndarray) -> np.ndarray:
    """gray -> RGB and alpha dropped, staying uint8; the one definition
    lives with the encoder."""
    from .models.encoder import to_rgb_uint8 as impl
    return impl(image)


def bucket_for_shape(h: int, w: int, bucket_shapes) -> tuple:
    """Nearest bucket by log aspect ratio (a tie goes to the first
    listed)."""
    aspect = math.log(w / h)
    return min(bucket_shapes,
               key=lambda b: abs(math.log(b[1] / b[0]) - aspect))


def _resample_taps(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the bilinear filter and
    ``normalize_coeffs_8bpc``: (first input index [out], int64 weights
    [out, ksize] in 22-bit fixed point, zero past each output's span)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    t = np.abs(((x[None] + xmin[:, None]).astype(np.float64)
                - center[:, None] + 0.5) * (1.0 / filterscale))
    k = np.where((t < 1.0) & (x[None] < xmax[:, None]), 1.0 - t, 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):              # the C loop's order of the sum
        ww = ww + k[:, i]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0, 1, ww)[:, None],
                 k)
    return xmin, np.trunc(0.5 + k * (1 << 22)).astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampler along ``axis`` (0 rows, 1
    columns) of a uint8 [H, W, C] image, vectorised over the outputs."""
    in_size = img.shape[axis]
    xmin, kk = _resample_taps(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1]), in_size - 1)
    # 255 x (2^22 + a few) + 2^21 fits int32, as in Pillow's INT32 sums;
    # the resampled axis outermost, so that a tap gathers whole rows
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.int32)
    kk = kk.astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << 21, np.int32)
    for i in range(kk.shape[1]):
        acc += src[idx[:, i]] * kk[:, i, None, None]
    out = np.clip(acc >> 22, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_to_bucket(img_u8: np.ndarray, bucket: tuple) -> np.ndarray:
    """Bilinear resize of an RGB uint8 image to the bucket extent, as
    PIL's ``Image.resize(..., BILINEAR)`` gives it (the JAX package's
    resize). Identity when the image is already bucket-shaped: the bucket
    path then matches the exact path bit for bit."""
    if tuple(img_u8.shape[:2]) == tuple(bucket):
        return img_u8
    h, w = (int(v) for v in bucket)
    out = np.asarray(img_u8, np.uint8)
    if out.shape[1] != w:               # horizontal pass first
        out = _resample_axis(out, w, 1)
    if out.shape[0] != h:
        out = _resample_axis(out, h, 0)
    return np.ascontiguousarray(out)


def _dump(obj, *path_parts):
    path = os.path.join(*path_parts)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _load(*path_parts):
    with open(os.path.join(*path_parts)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Feature extraction (reference preprocess.py:23-50)
# ---------------------------------------------------------------------------

def check_store_format(store_format: str) -> None:
    """Refuse "h5" by name: the port writes no HDF5 (the card's machine has
    no h5py, and the port's data path reads only the native record
    format, ``.isc``)."""
    if store_format == "h5":
        raise ValueError(
            "store_format 'h5': the port writes no HDF5 (its data path "
            "reads only the native record format, .isc); use 'native'")


def extract_imgs_feat(imgs_dir: str, feats_dir: str, encoder_params,
                      att_size: int = 14, store_format: str = "native",
                      dtype: str = "float32", batch_size: int = 8,
                      bucket_mode: str = "exact",
                      bucket_shapes=DEFAULT_BUCKET_SHAPES, *,
                      device="cuda", use_kernels: bool = True) -> list:
    """fc/att features of every image in ``imgs_dir`` (sorted by name)
    into ``feats_dir``/feats_fc.isc and feats_att.isc, keyed by file name
    (the reference's keying), through the ResNet-101 of ``encoder_params``
    (moved to ``device``) in the params' own dtype.

    The JAX package's two shape policies:

    * ``bucket_mode="exact"``: images keep their sizes (the reference
      never resizes, preprocess.py:23-50), normalised on the host and
      batched by exact (H, W) into ``encoder.forward_batch``;
    * ``bucket_mode="resize"``: each image goes to its nearest bucket of
      ``bucket_shapes`` by log aspect (``bucket_for_shape``), is resized
      there on the host (``resize_to_bucket``, PIL's bilinear) and batched
      as raw uint8 into ``encoder.forward_raw_batch`` (the normalisation
      folded into conv1). An image already at a bucket's shape is not
      resized.

    A batch is flushed when it holds ``batch_size`` images of one shape,
    and the partial ones at the end, padded by repeating their last image
    (so every forward has ``batch_size`` rows, as in the JAX package): on
    the card the stem's max-pool kernel launches once a flushed batch.
    ``use_kernels=False`` runs the pool's plain version on the card too
    (the smoke check's reference run). ``store_format`` "h5" is refused
    with ValueError (the port writes and reads the native format only).
    Returns the [(name, fc, att)] rows written, as numpy float32."""
    from .models import encoder as enc

    check_store_format(store_format)
    if bucket_mode not in ("exact", "resize"):
        raise ValueError(f"bucket_mode must be exact|resize: {bucket_mode}")
    dev = resolve_device(device)
    params = to_device(encoder_params, dev)
    imgs = sorted(os.listdir(imgs_dir))
    os.makedirs(feats_dir, exist_ok=True)

    @torch.no_grad()
    def fwd(x: np.ndarray):
        x = torch.from_numpy(x).to(dev)
        if bucket_mode == "resize":
            fc, att = enc.forward_raw_batch(params, x, att_size,
                                            use_kernels=use_kernels)
        else:
            fc, att = enc.forward_batch(params, x, att_size,
                                        use_kernels=use_kernels)
        return (fc.float().cpu().numpy(), att.float().cpu().numpy())

    def feats():
        buckets: Dict[tuple, list] = {}

        def flush(shape):
            names, arrs = zip(*buckets.pop(shape))
            n = len(arrs)
            if n < batch_size:  # padded to the batch size
                arrs = arrs + (arrs[-1],) * (batch_size - n)
            fc, att = fwd(np.stack(arrs))
            for i, nm in enumerate(names):
                yield nm, fc[i], att[i]

        for img_nm in imgs:
            img = load_image(os.path.join(imgs_dir, img_nm))
            if bucket_mode == "resize":
                img = to_rgb_uint8(img)
                x = resize_to_bucket(
                    img, bucket_for_shape(img.shape[0], img.shape[1],
                                          bucket_shapes))
            else:
                x = enc.preprocess(img)
            buckets.setdefault(tuple(x.shape), []).append((img_nm, x))
            if len(buckets[tuple(x.shape)]) >= batch_size:
                yield from flush(tuple(x.shape))
        for shape in list(buckets):
            yield from flush(shape)

    items = list(feats())
    write_native_store(os.path.join(feats_dir, "feats_fc.isc"),
                       ((nm, fc) for nm, fc, _ in items),
                       shape=items[0][1].shape, dtype=dtype)
    write_native_store(os.path.join(feats_dir, "feats_att.isc"),
                       ((nm, att) for nm, _, att in items),
                       shape=items[0][2].shape, dtype=dtype)
    return items


# ---------------------------------------------------------------------------
# Caption datasets (reference preprocess.py:53-90)
# ---------------------------------------------------------------------------

def process_caption_datasets(caption_datasets_dir: str, captions_dir: str,
                             dataset_names: List[str]) -> None:
    for dataset_nm in dataset_names:
        print(f"===> process {dataset_nm} dataset")
        images = _load(caption_datasets_dir,
                       f"dataset_{dataset_nm}.json")["images"]
        img_captions = {"train": {}, "val": {}, "test": {}}
        img_captions_pos = {"train": {}, "val": {}, "test": {}}
        img_concepts = {"train": {}, "val": {}, "test": {}}
        for image in images:
            fn = image["filename"]
            split = image["split"]
            if split == "restval":
                split = "train"
            img_captions[split][fn] = []
            img_captions_pos[split][fn] = []
            concepts = set()
            sents = [text.tokenize(s["raw"].lower())
                     for s in image["sentences"]]
            for tagged in text.pos_tag_sents(sents):
                words, poses = [], []
                for w, p in tagged:
                    if p == ".":  # remove punctuation
                        continue
                    words.append(w)
                    poses.append(p)
                    if p in CONCEPT_POS:
                        concepts.add(w)
                img_captions[split][fn].append(words)
                img_captions_pos[split][fn].append(poses)
            img_concepts[split][fn] = sorted(concepts)

        _dump(img_captions, captions_dir, dataset_nm, "img_captions.json")
        _dump(img_captions_pos, captions_dir, dataset_nm,
              "img_captions_pos.json")
        _dump(img_concepts, captions_dir, dataset_nm, "img_concepts.json")


# ---------------------------------------------------------------------------
# Sentiment corpus mining (reference preprocess.py:93-213)
# ---------------------------------------------------------------------------

def process_senti_corpus(corpus_dir: str,
                         corpus_type: str = "part") -> None:
    senti_corpus = _load(corpus_dir, corpus_type, "senti_corpus.json")

    # artifact names (tmp_senti_corpus*.json, sentiment_detector.json)
    # and the tf·ratio algorithm are the reference compatibility
    # contract; internals below are this module's own
    tokens_by_label = defaultdict(list)
    tags_by_label = defaultdict(list)
    adj_counts_all: Counter = Counter()
    adj_counts: Dict[str, Counter] = defaultdict(Counter)
    noun_to_adjs: Dict[str, Counter] = defaultdict(Counter)

    for senti_label, sents in senti_corpus.items():
        toks = [text.tokenize(s.strip().lower()) for s in sents]
        for tagged in text.pos_tag_sents(toks):
            kept = [(w, p) for w, p in tagged if p != "."]
            sent_adjs = [w for w, p in kept if p == "ADJ"]
            tokens_by_label[senti_label].append([w for w, _ in kept])
            tags_by_label[senti_label].append([p for _, p in kept])
            if sent_adjs:
                adj_counts_all.update(sent_adjs)
                adj_counts[senti_label].update(sent_adjs)
                for noun in (w for w, p in kept if p == "NOUN"):
                    noun_to_adjs[noun].update(sent_adjs)

    _dump(tokens_by_label, corpus_dir, corpus_type,
          "tmp_senti_corpus.json")
    _dump(tags_by_label, corpus_dir, corpus_type,
          "tmp_senti_corpus_pos.json")

    # tf·ratio scoring of adjectives (reference :135-158)
    frequent_adjs = {w: n for w, n in adj_counts_all.most_common()
                     if n >= 3}
    label_totals = {k: sum(v.values()) for k, v in adj_counts.items()}
    tf_ratio: Dict[str, Dict[str, float]] = defaultdict(dict)
    for k, cnt in adj_counts.items():
        for w, n in cnt.items():
            if w in frequent_adjs:
                tf = n / label_totals[k]
                tf_ratio[k][w] = tf * (n / frequent_adjs[w])

    sentiment_words = {
        k: [w for w, _ in sorted(v.items(), key=lambda p: p[1],
                                 reverse=True)]
        for k, v in tf_ratio.items()}

    # pos/neg disjointification (reference :166-184): a word ranked in
    # both polarity lists is dropped from both when the ranks are close
    # (< 5 apart), otherwise kept only where it ranks higher
    drop_both, drop_from_pos, drop_from_neg = [], [], []
    neg_ranked = sentiment_words.get("negative", [])
    for pos_rank, w in enumerate(sentiment_words.get("positive", [])):
        if w in neg_ranked:
            neg_rank = neg_ranked.index(w)
            if abs(pos_rank - neg_rank) < 5:
                drop_both.append(w)
            elif pos_rank > neg_rank:
                drop_from_pos.append(w)
            else:
                drop_from_neg.append(w)
    for w in drop_both:
        sentiment_words["positive"].remove(w)
        sentiment_words["negative"].remove(w)
    for w in drop_from_pos:
        sentiment_words["positive"].remove(w)
    for w in drop_from_neg:
        sentiment_words["negative"].remove(w)

    sentiment_words = {senti: {w: tf_ratio[senti][w] for w in ws}
                       for senti, ws in sentiment_words.items()}
    _dump(sentiment_words, corpus_dir, corpus_type, "sentiment_words.json")

    # noun -> weighted senti-word table (reference :196-213)
    flat_words: Dict[str, float] = {}
    flat_words.update(sentiment_words.get("positive", {}))
    flat_words.update(sentiment_words.get("negative", {}))
    table: Dict[str, List] = {}
    for noun, senti_cnt in noun_to_adjs.items():
        total = sum(senti_cnt.values())
        entries = [(w, n / total * flat_words[w])
                   for w, n in senti_cnt.most_common() if w in flat_words]
        if entries and len(entries) <= 50:
            table[noun] = entries
    _dump(table, corpus_dir, corpus_type, "sentiment_detector.json")


# ---------------------------------------------------------------------------
# Vocabularies (reference preprocess.py:216-225, 250-277)
# ---------------------------------------------------------------------------

def build_idx2concept(captions_dir: str, dataset_names: List[str],
                      top_k: int = 2000) -> None:
    for dataset_nm in dataset_names:
        img_concepts = _load(captions_dir, dataset_nm, "img_concepts.json")
        tc: Counter = Counter()
        for concepts in img_concepts.values():
            for cs in concepts.values():
                tc.update(cs)
        idx2concept = [w for w, _ in tc.most_common()[:top_k]]
        _dump(idx2concept, captions_dir, dataset_nm, "idx2concept.json")


def build_idx2word(captions_dir: str, corpus_dir: str,
                   dataset_names: List[str],
                   corpus_type: str = "part") -> None:
    senti_corpus = _load(corpus_dir, corpus_type, "tmp_senti_corpus.json")
    sentiment_words = _load(corpus_dir, corpus_type, "sentiment_words.json")
    idx2sentiment = [w for v in sentiment_words.values() for w in v]

    for dataset_nm in dataset_names:
        img_captions = _load(captions_dir, dataset_nm, "img_captions.json")
        idx2concept = _load(captions_dir, dataset_nm, "idx2concept.json")

        tc: Counter = Counter()
        for captions in img_captions.values():
            for caps in captions.values():
                for cap in caps:
                    tc.update(cap)
        for captions in senti_corpus.values():
            for cap in captions:
                tc.update(cap)
        idx2word = [w for w, n in tc.most_common() if n > 5]
        idx2word.extend(idx2sentiment)
        idx2word.extend(idx2concept)
        # sorted() where the reference uses raw set order (hash-dependent)
        idx2word = sorted(set(idx2word))
        idx2word = ["<PAD>", "<SOS>", "<EOS>", "<UNK>"] + idx2word
        _dump(idx2word, captions_dir, dataset_nm, corpus_type,
              "idx2word.json")


# ---------------------------------------------------------------------------
# Sentiment-image labels (reference preprocess.py:228-247)
# ---------------------------------------------------------------------------

def get_img_senti_labels(senti_imgs_dir: str, out_file: str,
                         seed: Optional[int] = 0) -> None:
    """Split sentiment-labeled images (label = filename prefix before '_')
    into val(100/100/50)/test(100/100/50)/train(rest). Seeded for
    determinism (the reference uses the global random state)."""
    rng = random.Random(seed)
    senti_imgs = defaultdict(list)
    for fn in sorted(os.listdir(senti_imgs_dir)):
        senti = fn.split("_")[0]
        senti_imgs[senti].append((fn, senti))
    for senti in ("positive", "negative", "neutral"):
        rng.shuffle(senti_imgs[senti])
    out = {"train": [], "val": [], "test": []}
    out["val"] += senti_imgs["positive"][:100]
    out["val"] += senti_imgs["negative"][:100]
    out["val"] += senti_imgs["neutral"][:50]
    out["test"] += senti_imgs["positive"][100:200]
    out["test"] += senti_imgs["negative"][100:200]
    out["test"] += senti_imgs["neutral"][50:100]
    out["train"] += senti_imgs["positive"][200:]
    out["train"] += senti_imgs["negative"][200:]
    out["train"] += senti_imgs["neutral"][100:]
    _dump({k: [list(p) for p in v] for k, v in out.items()}, out_file)


# ---------------------------------------------------------------------------
# Detected sentiment words per image (reference preprocess.py:280-302)
# ---------------------------------------------------------------------------

def _rank_sentis(cpts, detector_table) -> List[str]:
    """Sentiment words of the concepts' table entries, scores summed per
    word, ranked by the sum (descending; equal sums keep first-seen
    order)."""
    sentis = []
    for con in cpts:
        sentis.extend(detector_table.get(con, []))
    if not sentis:
        return []
    acc: Dict[str, float] = defaultdict(float)
    for w, s in sentis:
        acc[w] += s
    return [w for w, _ in sorted(acc.items(), key=lambda p: p[1],
                                 reverse=True)]


def get_img_det_sentiments(captions_dir: str, corpus_dir: str,
                           dataset_names: List[str],
                           corpus_type: str = "part") -> None:
    detector = _load(corpus_dir, corpus_type, "sentiment_detector.json")
    for dataset_nm in dataset_names:
        det_concepts = _load(captions_dir, dataset_nm,
                             "img_det_concepts.json")
        det_sentiments = {fn: _rank_sentis(cpts, detector)[:20]
                          for fn, cpts in det_concepts.items()}
        _dump(det_sentiments, captions_dir, dataset_nm, corpus_type,
              "img_det_sentiments.json")


# ---------------------------------------------------------------------------
# senti_captions (reference preprocess.py:305-390)
# ---------------------------------------------------------------------------

def get_senti_captions(captions_dir: str, corpus_dir: str,
                       dataset_names: List[str],
                       corpus_type: str = "part") -> None:
    detector = _load(corpus_dir, corpus_type, "sentiment_detector.json")
    senti_corpus = _load(corpus_dir, corpus_type, "tmp_senti_corpus.json")
    senti_corpus_pos = _load(corpus_dir, corpus_type,
                             "tmp_senti_corpus_pos.json")
    sentiment_words = _load(corpus_dir, corpus_type, "sentiment_words.json")
    idx2sentiment = {w for v in sentiment_words.values() for w in v}

    senti_captions = defaultdict(list)
    for senti in senti_corpus:
        for cap, pos in zip(senti_corpus[senti], senti_corpus_pos[senti]):
            cpts = sorted({cap[j] for j, p in enumerate(pos)
                           if p in CONCEPT_POS})
            sentis = _rank_sentis(cpts, detector)
            if sentis:
                senti_captions[senti].append([cap, cpts[:20], sentis[:20]])

    for dataset_nm in dataset_names:
        img_captions = _load(captions_dir, dataset_nm,
                             "img_captions.json")["train"]
        img_captions_pos = _load(captions_dir, dataset_nm,
                                 "img_captions_pos.json")["train"]
        fact_caps = []
        for fn, caps in img_captions.items():
            for cap, pos in zip(caps, img_captions_pos[fn]):
                if any(w in idx2sentiment for w in cap):
                    continue  # factual captions only (reference :356-361)
                cpts = sorted({cap[j] for j, p in enumerate(pos)
                               if p in CONCEPT_POS})
                sentis = _rank_sentis(cpts, detector)
                if sentis:
                    fact_caps.append([cap, cpts[:20], sentis[:20]])
        out = deepcopy(dict(senti_captions))
        out["neutral"] = fact_caps
        _dump(out, captions_dir, dataset_nm, corpus_type,
              "senti_captions.json")


def get_anno_captions(caption_datasets_dir: str, captions_dir: str,
                      dataset_names: List[str]) -> None:
    for dataset_nm in dataset_names:
        images = _load(caption_datasets_dir,
                       f"dataset_{dataset_nm}.json")["images"]
        anno = {img["filename"]: [s["raw"].strip().lower()
                                  for s in img["sentences"]]
                for img in images if img["split"] == "test"}
        _dump(anno, captions_dir, dataset_nm, "anno_captions.json")


# ---------------------------------------------------------------------------
# Per-sentiment LMs (reference preprocess.py:408-466)
# ---------------------------------------------------------------------------

def _isclm_binary() -> Optional[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    for cand in (os.path.join(here, "..", "native", "build", "isclm"),
                 shutil.which("isclm")):
        if cand and os.path.exists(cand):
            return cand
    return None


def get_lm_sents(captions_dir: str, dataset_names: List[str],
                 corpus_type: str = "part") -> None:
    """Write per-sentiment sentence files and train trigram LMs (.sri,
    ARPA format). Backend: SRILM ngram-count when present, else the
    in-tree C++ isclm trainer (same interpolated modified-KN estimator
    family, same ARPA output). KenLM arpa files additionally when lmplz
    exists."""
    for dataset_nm in dataset_names:
        senti_captions = _load(captions_dir, dataset_nm, corpus_type,
                               "senti_captions.json")
        lm_dir = os.path.join(captions_dir, dataset_nm, corpus_type, "lm")
        os.makedirs(lm_dir, exist_ok=True)
        for senti, caps in senti_captions.items():
            with open(os.path.join(lm_dir, f"{senti}_w.txt"), "w") as f:
                f.write("".join(" ".join(c[0]) + "\n" for c in caps))

        use_srilm = shutil.which("ngram-count") is not None
        isclm = None if use_srilm else _isclm_binary()
        for fn in sorted(os.listdir(lm_dir)):
            if not fn.endswith("_w.txt"):
                continue
            stem = fn.split(".")[0]
            txt = os.path.join(lm_dir, fn)
            sri = os.path.join(lm_dir, f"{stem}.sri")
            if use_srilm:
                cnt = os.path.join(lm_dir, f"{stem}.count")
                subprocess.run(["ngram-count", "-text", txt, "-order", "3",
                                "-write", cnt], check=True)
                subprocess.run(["ngram-count", "-read", cnt, "-order", "3",
                                "-lm", sri, "-interpolate", "-kndiscount"],
                               check=True)
            elif isclm:
                subprocess.run([isclm, "train", txt, sri], check=True)
            else:
                raise RuntimeError(
                    "no LM trainer: install SRILM or build the in-tree "
                    "isclm (`make -C native`)")

        # id-form sentences + KenLM arpa (reference :441-466; optional)
        idx2word = _load(captions_dir, dataset_nm, corpus_type,
                         "idx2word.json")
        word2idx = {w: i for i, w in enumerate(idx2word)}
        unk, eos = word2idx["<UNK>"], word2idx["<EOS>"]
        have_kenlm = shutil.which("lmplz") is not None
        for senti, caps in senti_captions.items():
            lines = []
            for c in caps:
                ids = [word2idx.get(w, None) or unk for w in c[0]] + [eos]
                lines.append(" ".join(map(str, ids)))
            id_txt = os.path.join(lm_dir, f"{senti}_id.txt")
            with open(id_txt, "w") as f:
                f.write("\n".join(lines))
            if have_kenlm:
                arpa = os.path.join(lm_dir, f"{senti}_id.kenlm.arpa")
                with open(id_txt) as fin, open(arpa, "w") as fout:
                    subprocess.run(["lmplz", "-o", "3"], stdin=fin,
                                   stdout=fout, check=True)
            # id-form ARPA (.sri) — input of the RL LM reward
            # (--rl_lm_flag; reference wires kenlm arpa here,
            # train_rl.py:212-216, default-off)
            id_sri = os.path.join(lm_dir, f"{senti}_id.sri")
            if use_srilm:
                cnt = os.path.join(lm_dir, f"{senti}_id.count")
                subprocess.run(["ngram-count", "-text", id_txt, "-order",
                                "3", "-write", cnt], check=True)
                subprocess.run(["ngram-count", "-read", cnt, "-order", "3",
                                "-lm", id_sri, "-interpolate",
                                "-kndiscount"], check=True)
            elif isclm:
                subprocess.run([isclm, "train", id_txt, id_sri], check=True)
        if not have_kenlm:
            print("note: lmplz not found — KenLM arpa files skipped "
                  "(unused by the runtime, SURVEY.md §2.5)")
