# Copied from beats3d_tpu/utils/orbit_html.py (host only).
"""Self-contained interactive HTML orbit viewer for 3D point sets.

The reference debugs 3D geometry through live GL windows (pptk in
src/pointcloids.py, the arcball view in src/pose_fit.py:90-385 /
src/camera/arcball.py:5-21); on a headless TPU host the equivalent is a
single HTML file — drag to orbit, wheel to zoom — shared by the
``pointcloids`` and ``pose_fit`` apps.
"""

import json

import numpy as np

_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>%TITLE%</title><style>
 body{margin:0;background:#0b0b10;color:#ccc;font:12px monospace}
 #info{position:fixed;top:8px;left:10px;white-space:pre}
 canvas{display:block}
</style></head><body>
<div id="info">%INFO% — drag: orbit, wheel: zoom</div>
<canvas id="c"></canvas>
<script>
const pts=%POINTS%; const cols=%COLORS%;
const cv=document.getElementById('c'), g=cv.getContext('2d');
let W,H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
rs(); onresize=rs;
let rx=-0.9, rz=0.0, zoom=0.9, cx=0, cy=0, czm=0;
for(const p of pts){cx+=p[0];cy+=p[1];czm+=p[2];}
cx/=pts.length; cy/=pts.length; czm/=pts.length;
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return; rz+=(e.clientX-drag[0])*0.008;
 rx+=(e.clientY-drag[1])*0.008; drag=[e.clientX,e.clientY]; draw();};
onwheel=e=>{zoom*=e.deltaY<0?1.1:0.9; draw();};
function draw(){
 g.fillStyle='#0b0b10'; g.fillRect(0,0,W,H);
 const s=Math.min(W,H)*zoom*0.0004;
 const ca=Math.cos(rz),sa=Math.sin(rz),cb=Math.cos(rx),sb=Math.sin(rx);
 for(let i=0;i<pts.length;i++){
  const x=pts[i][0]-cx, y=pts[i][1]-cy, z=pts[i][2]-czm;
  const x1=x*ca-y*sa, y1=x*sa+y*ca;
  const y2=y1*cb-z*sb, z2=y1*sb+z*cb;
  g.fillStyle=cols[i];
  g.fillRect(W/2+x1*s, H/2+y2*s, 2, 2);
 }
}
draw();
</script></body></html>"""


def write_orbit_html(path, points, colors, info, title="beats3d view"):
    """Write an orbit-viewer HTML: ``points`` (N, 3) array-like, ``colors``
    N CSS color strings (one per point), ``info`` the header line."""
    points = np.asarray(points, np.float64)
    colors = list(colors)
    assert points.ndim == 2 and points.shape[1] == 3, points.shape
    assert len(colors) == points.shape[0], (len(colors), points.shape)
    html = (
        _HTML
        .replace("%TITLE%", title)
        .replace("%INFO%", info)
        .replace("%POINTS%", json.dumps(np.round(points, 1).tolist()))
        .replace("%COLORS%", json.dumps(colors))
    )
    with open(path, "w") as f:
        f.write(html)
