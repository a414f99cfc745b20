"""OpenCV's drawing primitives in numpy, pixel for pixel, for the
synthetic corpora (``make_synth_data.py``, ``make_mock_data.py``), whose
JAX counterparts draw with ``cv2.circle``, ``cv2.rectangle`` and
``cv2.fillPoly``.  The port imports no OpenCV, so this module follows
the integer rules of OpenCV's ``imgproc/src/drawing.cpp``, 8-connected
lines (``LINE_8``) and no sub-pixel ``shift`` on the caller's side:

* :func:`circle` filled: the ``Circle`` routine (midpoint spans);
* :func:`circle` with ``thickness > 1``: ``EllipseEx``: the circle as a
  polygon (``ellipse2Poly`` over OpenCV's float sine table, with the step
  of its radius), then ``PolyLine`` of thick segments, each a filled
  quadrangle in 16-bit fixed point (``FillConvexPoly`` with its outline
  by ``Line2``) and a filled disc at its joints;
* :func:`rectangle` filled: ``FillConvexPoly`` on the four corners;
* :func:`fill_poly`: ``CollectPolyEdges`` (each edge also drawn as an
  8-connected line, ``LineIterator``) and the even-odd scan of
  ``FillEdgeCollection``, convex or not.

Images are HWC uint8 and are drawn in place; ``color`` is a tuple of
integers, one per channel.  Integer division and shifts follow C's
(division truncates toward zero, ``>>`` floors).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# OpenCV's table of sin(i degrees), i = 0..450, as float32 of 7 decimals.
_SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(np.float32)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _round(x: float) -> int:
    """``cvRound``: to the nearest integer, ties to even."""
    return int(round(x))


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def clip_line(width: int, height: int, p1: List[int], p2: List[int]) -> bool:
    """``clipLine``: clip the segment p1-p2 (lists, changed in place) to
    [0, width-1] x [0, height-1]; False if nothing of it is inside."""
    if width <= 0 or height <= 0:
        return False
    right, bottom = width - 1, height - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def line(img: np.ndarray, pt1: Sequence[int], pt2: Sequence[int],
         color) -> None:
    """An 8-connected line in whole pixels (``Line`` over
    ``LineIterator``, left to right)."""
    h, w = img.shape[:2]
    p1, p2 = [int(pt1[0]), int(pt1[1])], [int(pt2[0]), int(pt2[1])]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w
            and 0 <= p1[1] < h and 0 <= p2[1] < h):
        if not clip_line(w, h, p1, p2):
            return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    step_x, step_y = 1, 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = color
        minor = err < 0
        err += minus_delta + (plus_delta if minor else 0)
        if vert:
            y += step_y
            x += step_x if minor else 0
        else:
            x += step_x
            y += step_y if minor else 0


def _line2(img: np.ndarray, pt1: Sequence[int], pt2: Sequence[int],
           color) -> None:
    """A line between points in 16-bit fixed point (``Line2``)."""
    h, w = img.shape[:2]
    p1, p2 = [int(pt1[0]), int(pt1[1])], [int(pt2[0]), int(pt2[1])]
    if not clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2):
        return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            p1, p2 = p2, p1
            dy = -dy
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (p2[0] - p1[0]) >> XY_SHIFT
    else:
        if dy < 0:
            p1, p2 = p2, p1
            dx = -dx
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (p2[1] - p1[1]) >> XY_SHIFT
    x1, y1 = p1[0] + (XY_ONE >> 1), p1[1] + (XY_ONE >> 1)
    _put(img, (p2[0] + (XY_ONE >> 1)) >> XY_SHIFT,
         (p2[1] + (XY_ONE >> 1)) >> XY_SHIFT, color)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1, y1 >> XY_SHIFT, color)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1 >> XY_SHIFT, y1, color)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(img: np.ndarray, v: Sequence[Tuple[int, int]], color,
                      shift: int) -> None:
    """``FillConvexPoly`` (8-connected): the outline (``Line`` for
    ``shift`` 0, else ``Line2``), then the spans between the polygon's two
    chains, walked in 16-bit fixed point."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    delta1 = delta2 = XY_ONE >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax = max(ymax, py)
        xmax = max(xmax, px)
        xmin = min(xmin, px)
        p = (px << up, py << up)
        if shift == 0:
            line(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                 (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin = (xmin + delta) >> shift
    xmax = (xmax + delta) >> shift
    ymin = (ymin + delta) >> shift
    ymax = (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # Per chain: [vertex index, direction, x, dx, end row].
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = idx0 + di
            if idx >= npts:
                idx -= npts
            while True:
                if edges <= 0:
                    edges -= 1
                    break
                edges -= 1
                ty = (v[idx][1] + delta) >> shift
                if ty > y:
                    xs, xe = v[idx0][0] << up, v[idx][0] << up
                    e[4] = ty
                    e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    e[2] = xs
                    e[0] = idx
                    break
                idx0 = idx
                idx += di
                if idx >= npts:
                    idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + delta1) >> XY_SHIFT
            xx2 = (edge[right][2] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _circle_spans(cx: int, cy: int, radius: int):
    """The (row, x1, x2) spans of ``Circle``'s filled disc."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        yield cy - dy, cx - dx, cx + dx
        yield cy + dy, cx - dx, cx + dx
        yield cy - dx, cx - dy, cx + dy
        yield cy + dx, cx - dy, cx + dy
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _filled_circle(img: np.ndarray, cx: int, cy: int, radius: int,
                   color) -> None:
    h, w = img.shape[:2]
    for y, x1, x2 in _circle_spans(cx, cy, radius):
        if 0 <= y < h and x2 >= 0 and x1 < w:
            _hline(img, y, max(x1, 0), min(x2, w - 1), color)


def _thick_line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
                color, thickness: int, flags: int) -> None:
    """``ThickLine`` for ``thickness > 1`` between fixed-point points: the
    quadrangle of the segment, and a disc at the ends that ``flags`` names
    (1 the first, 2 the second)."""
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
        ddx, ddy = _round(dy * r), _round(dx * r)
        _fill_convex_poly(img, [(p0[0] + ddx, p0[1] + ddy),
                                (p0[0] - ddx, p0[1] - ddy),
                                (p1[0] - ddx, p1[1] - ddy),
                                (p1[0] + ddx, p1[1] + ddy)], color, XY_SHIFT)
    for i in range(2):
        if flags & (i + 1):
            _filled_circle(img, (p0[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                           (p0[1] + (XY_ONE >> 1)) >> XY_SHIFT,
                           (half + (XY_ONE >> 1)) >> XY_SHIFT, color)
        p0 = p1


def _ellipse_points(cx: int, cy: int, radius: int) -> List[Tuple[int, int]]:
    """``EllipseEx``'s polygon of a whole circle of ``radius`` about
    (cx, cy), in fixed point: ``ellipse2Poly`` at the angle step of the
    radius, each point rounded, repeats dropped."""
    ax = radius << XY_SHIFT
    delta = (ax + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    center_x, center_y = float(cx << XY_SHIFT), float(cy << XY_SHIFT)
    pts: List[Tuple[int, int]] = []
    for i in range(0, 360 + delta, delta):
        angle = min(i, 360)
        x = ax * float(_SIN_TABLE[450 - angle])
        y = ax * float(_SIN_TABLE[angle])
        pt = (_round(center_x + x), _round(center_y + y))
        if not pts or pt != pts[-1]:
            pts.append(pt)
    if len(pts) == 1:
        pts = [(cx << XY_SHIFT, cy << XY_SHIFT)] * 2
    return pts


def circle(img: np.ndarray, center: Sequence[int], radius: int, color,
           thickness: int = 1) -> None:
    """``cv2.circle`` with ``LINE_8``: filled for ``thickness < 0``, a
    ring of ``thickness`` pixels for ``thickness > 1``."""
    cx, cy = int(center[0]), int(center[1])
    if thickness < 0:
        _filled_circle(img, cx, cy, int(radius), color)
        return
    if thickness <= 1:
        raise NotImplementedError("one-pixel circles: no corpus draws them")
    pts = _ellipse_points(cx, cy, int(radius))
    p0 = pts[0]
    for i, p in enumerate(pts[1:]):
        _thick_line(img, p0, p, color, thickness, 3 if i == 0 else 2)
        p0 = p


def rectangle(img: np.ndarray, pt1: Sequence[int], pt2: Sequence[int],
              color) -> None:
    """``cv2.rectangle`` filled (``thickness`` -1)."""
    (x1, y1), (x2, y2) = pt1, pt2
    _fill_convex_poly(img, [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], color, 0)


def fill_poly(img: np.ndarray, pts: Sequence[Sequence[int]], color) -> None:
    """``cv2.fillPoly`` of one polygon in whole pixels, convex or not:
    every edge drawn as a line, then on each row the spans between pairs
    of edge crossings (even-odd), from the ceiling of the left crossing to
    the floor of the right one.  An edge with an end outside the image
    takes its x from the segment clipped to the image (its rows too,
    unless the clipped segment is flat)."""
    h, w = img.shape[:2]
    v = [(int(p[0]), int(p[1])) for p in pts]
    edges = []  # [y0, x, dx, y1] in fixed point
    pt0 = (v[-1][0] << XY_SHIFT, v[-1][1])
    for px, py in v:
        pt1 = (px << XY_SHIFT, py)
        t0 = [(pt0[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt0[1]]
        t1 = [(pt1[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt1[1]]
        line(img, t0, t1, color)
        c0, c1 = list(pt0), list(pt1)
        if not (0 <= t0[0] < w and 0 <= t1[0] < w
                and 0 <= t0[1] < h and 0 <= t1[1] < h):
            clip_line(w, h, t0, t1)
            if t0[1] != t1[1]:
                c0[1], c1[1] = t0[1], t1[1]
            c0[0], c1[0] = t0[0] << XY_SHIFT, t1[0] << XY_SHIFT
        if pt0[1] != pt1[1]:
            dx = _cdiv(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                edges.append([pt0[1], c0[0] + (pt0[1] - c0[1]) * dx, dx,
                              pt1[1]])
            else:
                edges.append([pt1[1], c1[0] + (pt1[1] - c1[1]) * dx, dx,
                              pt0[1]])
        pt0 = pt1
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[3] for e in edges)
    x_ends = [e[1] for e in edges] + [e[1] + (e[3] - e[0]) * e[2]
                                      for e in edges]
    if y_max < 0 or y_min >= h or max(x_ends) < 0 \
            or min(x_ends) >= (w << XY_SHIFT):
        return
    for y in range(y_min, min(y_max, h)):
        active = [e for e in edges if e[0] <= y < e[3]]
        xs = sorted(e[1] for e in active)
        if y >= 0:
            for a, b in zip(xs[0::2], xs[1::2]):
                x1, x2 = (a + XY_ONE - 1) >> XY_SHIFT, b >> XY_SHIFT
                if x1 < w and x2 >= 0:
                    _hline(img, y, max(x1, 0), min(x2, w - 1), color)
        for e in active:
            e[1] += e[2]


__all__ = ["circle", "clip_line", "fill_poly", "line", "rectangle"]
