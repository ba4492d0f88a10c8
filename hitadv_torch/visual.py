"""Single-sample attack visualiser: ``python -m hitadv_torch.visual``.

Port of `hitadv_tpu/visual.py` (reference `visual.py:22-69,130-225`):
load one cloud, attack it (B=1) through the evaluation's
`eval.build_model` and `eval.build_attack`, re-predict, and dump the
adversarial cloud; or, with ``--mode spectral``, split the cloud into
its low- and high-frequency parts over the graph Laplacian's
eigenvectors (`attacks.aof.graph_laplacian`). Headless: the reference's
mayavi window becomes an ``.asc`` point dump (xyz a line), a matplotlib
PNG scatter when matplotlib is installed, and a self-contained HTML
viewer. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime
from typing import Callable, Tuple

import numpy as np
import torch

from hitadv_torch import resolve_device


def save_asc(path: str, points: np.ndarray) -> None:
    """xyz a line (the ``.asc`` format of `visual.py:63-68`)."""
    np.savetxt(path, points, fmt="%.6f")


def save_png(path: str, points: np.ndarray,
             color: str = "#3380FF") -> bool:
    """A scatter render by matplotlib when it is installed; whether it
    wrote one."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=1, c=color)
    ax.set_axis_off()
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return True


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>hitadv_torch viewer</title>
<style>
 body {{ margin:0; background:#111; color:#ddd;
        font:13px system-ui, sans-serif; }}
 #hud {{ position:fixed; top:8px; left:10px; user-select:none; }}
 #hud label {{ margin-right: 14px; cursor:pointer; }}
 canvas {{ display:block; }}
</style></head><body>
<div id="hud">{toggles} &nbsp;drag: rotate &middot; wheel: zoom</div>
<canvas id="c"></canvas>
<script>
const CLOUDS = {clouds_json};
const COLORS = {colors_json};
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let rx = -0.4, ry = 0.6, zoom = 1.0, drag = null;
const shown = Object.fromEntries(Object.keys(CLOUDS).map(k => [k, true]));
for (const k of Object.keys(CLOUDS)) {{
  const el = document.getElementById("t_" + k);
  if (el) el.onchange = () => {{ shown[k] = el.checked; draw(); }};
}}
function draw() {{
  const W = cv.width = innerWidth, H = cv.height = innerHeight;
  ctx.clearRect(0, 0, W, H);
  const s = Math.min(W, H) * 0.35 * zoom;
  const ca = Math.cos(ry), sa = Math.sin(ry);
  const cb = Math.cos(rx), sb = Math.sin(rx);
  for (const [name, pts] of Object.entries(CLOUDS)) {{
    if (!shown[name]) continue;
    ctx.fillStyle = COLORS[name];
    for (let i = 0; i < pts.length; i += 3) {{
      const x = pts[i], y = pts[i+1], z = pts[i+2];
      const x1 = ca*x + sa*z, z1 = -sa*x + ca*z;
      const y1 = cb*y - sb*z1, z2 = sb*y + cb*z1;
      const p = 2.2 / (2.2 + z2);
      ctx.globalAlpha = Math.max(0.25, Math.min(1, p));
      const r = Math.max(1, 2.2 * p * zoom);
      ctx.fillRect(W/2 + x1*s*p - r/2, H/2 - y1*s*p - r/2, r, r);
    }}
  }}
  ctx.globalAlpha = 1;
}}
cv.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => {{
  if (!drag) return;
  ry += (e.clientX - drag[0]) * 0.008;
  rx += (e.clientY - drag[1]) * 0.008;
  drag = [e.clientX, e.clientY]; draw();
}};
window.onwheel = e => {{ zoom *= e.deltaY < 0 ? 1.1 : 0.9; draw(); }};
window.onresize = draw;
draw();
</script></body></html>
"""

_PALETTE = ("#57a9f7", "#f7705c", "#7ed87e", "#e5c055", "#c08df0")


def save_html(path: str, clouds: dict) -> None:
    """A self-contained interactive 3-D viewer (rotate, zoom, toggle) in
    place of the reference's blocking mayavi window (`visual.py:51-69`):
    one HTML file with the clouds embedded as JSON and a small canvas
    renderer, for any browser, with no GUI stack or network on the host.
    ``clouds`` maps a name to an ``[N, 3]`` array; each gets a colour and
    an on/off toggle."""
    import json

    names = list(clouds)
    clouds_json = json.dumps({
        n: [round(float(v), 5) for v in np.asarray(c)[:, :3].ravel()]
        for n, c in clouds.items()})
    colors_json = json.dumps({
        n: _PALETTE[i % len(_PALETTE)] for i, n in enumerate(names)})
    toggles = " ".join(
        f'<label><input type="checkbox" id="t_{n}" checked> '
        f'<span style="color:{_PALETTE[i % len(_PALETTE)]}">{n}'
        f"</span></label>" for i, n in enumerate(names))
    with open(path, "w") as f:
        f.write(_HTML_TEMPLATE.format(clouds_json=clouds_json,
                                      colors_json=colors_json,
                                      toggles=toggles))


def spectral_decompose(points: np.ndarray, low_pass: int = 100,
                       k: int = 30, device="cuda"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The low- and high-frequency parts of ``points`` ``[N, 3]`` over the
    eigenvectors of its graph Laplacian (reference `visual.py:130-169`,
    the AOF attack's `graph_laplacian`): (lfc, hfc), each ``[N, 3]``, the
    projections on the ``low_pass`` lowest eigenvectors and on the rest;
    ``lfc + hfc == points`` up to rounding (the basis is orthonormal)."""
    from hitadv_torch.attacks.aof import graph_laplacian

    dev = resolve_device(device)
    pc = torch.as_tensor(np.asarray(points, np.float32)).to(dev)[None]
    _, V = graph_laplacian(pc, k=min(k, points.shape[0]))
    projs = torch.einsum("bnc,bnm->bmc", pc, V)               # [1, N, 3]
    lfc = torch.einsum("bmc,bnm->bnc", projs[:, :low_pass],
                       V[:, :, :low_pass])
    hfc = torch.einsum("bmc,bnm->bnc", projs[:, low_pass:],
                       V[:, :, low_pass:])
    return lfc[0].cpu().numpy(), hfc[0].cpu().numpy()


def evalit(logits_fn: Callable, attack_fn: Callable, data: np.ndarray,
           target: int, generator: torch.Generator, device="cuda"):
    """Attack one sample (reference `visual.py:22-48`): data ``[N, 3|6]``
    -> (adversarial points ``[N', 3]``, clean prediction, adversarial
    prediction, success)."""
    pts = torch.as_tensor(np.asarray(data, np.float32)).to(device)[None]
    labels = torch.tensor([target], dtype=torch.long, device=device)
    with torch.no_grad():
        clean_pred = int(torch.argmax(logits_fn(pts[..., :3]), -1)[0])
    res = attack_fn(pts, labels, generator)
    adv = res.adv_points[0].detach().cpu().numpy()
    return adv, clean_pred, int(res.pred[0]), bool(res.success[0])


def main(argv=None) -> np.ndarray:
    """The visualiser's command line: the evaluation's flags (`config`),
    ``--input`` (a comma-separated xyz[+normal] txt cloud; one synthetic
    cloud without it), ``--target``, ``--out_dir``, ``--mode attack |
    spectral`` and ``--low_pass``. Returns the adversarial cloud (attack)
    or the low-frequency part (spectral)."""
    from hitadv_torch.config import add_config_flags, config_from_args
    from hitadv_torch.data import pc_normalize, synthetic_clouds
    from hitadv_torch.eval import build_attack, build_model

    p = argparse.ArgumentParser("hitadv_torch visual")
    add_config_flags(p)
    p.add_argument("--input", default=None,
                   help="txt cloud (comma-separated xyz[+normal]); default: "
                        "one synthetic sample")
    p.add_argument("--target", type=int, default=0)
    p.add_argument("--out_dir", default="./visual_out")
    p.add_argument("--mode", default="attack",
                   choices=["attack", "spectral"],
                   help="attack: the adversarial sample's dump; spectral: "
                        "the Laplacian's lfc/hfc reconstructions "
                        "(`visual.py:130-169`)")
    p.add_argument("--low_pass", type=int, default=100,
                   help="spectral mode: the number of low-frequency "
                        "eigenvectors")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    dev = resolve_device(cfg.device)

    if args.input:
        data = np.loadtxt(args.input, delimiter=",").astype(np.float32)
        data = data[:cfg.num_point]
        data[:, :3] = pc_normalize(data[:, :3])
        target = args.target
    else:
        clouds, labels = synthetic_clouds(1, cfg.num_point, seed=cfg.seed)
        data, target = clouds[0], int(labels[0])

    os.makedirs(args.out_dir, exist_ok=True)
    stamp = datetime.now().strftime("%Y%m%d%H%M%S")
    if args.mode == "spectral":
        xyz = np.asarray(data[:, :3], np.float32)
        lfc, hfc = spectral_decompose(xyz, low_pass=args.low_pass,
                                      device=dev)
        outs = []
        for name, cloud in (("ori", xyz), ("lfc", lfc), ("hfc", hfc)):
            path = os.path.join(args.out_dir, f"{name}_{stamp}.asc")
            save_asc(path, cloud)
            outs.append(path)
            save_png(os.path.join(args.out_dir, f"{name}_{stamp}.png"),
                     cloud)
        html_path = os.path.join(args.out_dir, f"spectral_{stamp}.html")
        save_html(html_path, {"ori": xyz, "lfc": lfc, "hfc": hfc})
        outs.append(html_path)
        print(f"spectral split (low_pass={args.low_pass}): saved "
              + ", ".join(outs))
        return lfc

    model = build_model(cfg)
    attack = build_attack(cfg, model, model)
    adv, clean_pred, adv_pred, success = evalit(
        model, attack, data, target,
        torch.Generator(device=dev).manual_seed(cfg.seed), dev)

    asc_path = os.path.join(args.out_dir, f"adv_{stamp}.asc")
    save_asc(asc_path, adv)
    png_path = os.path.join(args.out_dir, f"adv_{stamp}.png")
    has_png = save_png(png_path, adv)
    html_path = os.path.join(args.out_dir, f"adv_{stamp}.html")
    save_html(html_path, {"clean": np.asarray(data[:, :3]), "adv": adv})
    print(f"clean pred {clean_pred}, adv pred {adv_pred}, "
          f"success {success}; saved {asc_path}, {html_path}"
          + (f" and {png_path}" if has_png else ""))
    return adv


if __name__ == "__main__":
    main()
