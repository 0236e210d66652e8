"""Self-contained interactive 3-D scene viewer (single HTML file, no deps).

The reference's L6 is a Slicer 3-D viewport (rotate/zoom/pan of the posed
robot + body + trajectory) plus a trajectory-simulation panel (slider +
play/pause stepping the arm through the planned path at 50 ms,
Mamri/Mamri.py:287-317). The headless framework's equivalents so far were
OBJ/GLB export and a rasterized PNG; this module closes the interactive gap:
`write_html_scene` emits ONE .html file embedding the scene and a vanilla
WebGL1 renderer — orbit (drag), zoom (wheel), pan (right-drag / shift-drag),
flat-shaded meshes, constant-color polylines, and (when `anim` is given)
a frame slider + play/pause animating per-link rigid transforms. No CDN,
no network, works offline in any browser.

Geometry is embedded quantized: per object a bbox + uint16 vertex grid
(base64), ~6 bytes/vertex — a 100k-triangle body surface is ~2.4 MB of
payload instead of ~7 MB as ASCII floats. Face normals are computed in JS
from the triangle soup (flat shading needs no stored normals). Animation
transforms are f32 base64 (frames x links x 16, column-major), ~52 KB for
a 101-sample 8-link path.
"""

from __future__ import annotations

import base64
import json
from typing import Optional, Sequence, Tuple

import numpy as np

# name -> [r, g, b, alpha]; anything unlisted cycles the tail palette
_COLORS = {
    "Baseplate": [0.45, 0.47, 0.52, 1.0],
    "Needle": [0.85, 0.20, 0.20, 1.0],
    "Body": [0.95, 0.78, 0.66, 0.45],
    "TrajectoryTipPath": [0.10, 0.55, 0.95, 1.0],
    "InsertionSegment": [0.95, 0.55, 0.10, 1.0],
}
_CYCLE = [
    [0.62, 0.66, 0.72, 1.0],
    [0.55, 0.62, 0.78, 1.0],
    [0.70, 0.63, 0.55, 1.0],
    [0.58, 0.72, 0.62, 1.0],
    [0.72, 0.58, 0.68, 1.0],
    [0.65, 0.70, 0.58, 1.0],
]


def _quantize(points: np.ndarray) -> Tuple[dict, np.ndarray]:
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    scale = np.maximum((hi - lo) / 65535.0, 1e-12)
    q = np.clip(np.round((pts - lo) / scale), 0, 65535).astype("<u2")
    meta = {"lo": [float(v) for v in lo], "scale": [float(v) for v in scale]}
    return meta, q


def write_html_scene(
    path: str,
    objects: Sequence,
    polylines: Sequence = (),
    anim: Optional[dict] = None,
    title: str = "mamri scene",
) -> int:
    """Write the assembled scene as one interactive HTML file.

    `objects`: [(name, (T, 3, 3) triangle array)] or
    [(name, tris, link_index)] — with a link index the triangles are in the
    LINK-LOCAL frame and `anim` must supply the world transforms.
    `polylines`: [(name, (N, 3) point array)] (always world-frame).
    `anim`: {"transforms": (frames, links, 4, 4) array, "interval_ms": 50}
    adds the trajectory-simulation slider + play control. Returns total
    bytes written."""
    meshes = []
    for i, entry in enumerate(objects):
        name, tris = entry[0], entry[1]
        link = int(entry[2]) if len(entry) > 2 else -1
        tris = np.asarray(tris, np.float32)
        if tris.size == 0:
            continue
        meta, q = _quantize(tris)
        meshes.append(
            {
                "name": name,
                "kind": "mesh",
                "link": link,
                **meta,
                "color": _COLORS.get(name, _CYCLE[i % len(_CYCLE)]),
                "data": base64.b64encode(q.tobytes()).decode("ascii"),
            }
        )
    for i, (name, pts) in enumerate(polylines):
        pts = np.asarray(pts, np.float32)
        if pts.size == 0:
            continue
        meta, q = _quantize(pts)
        meshes.append(
            {
                "name": name,
                "kind": "line",
                "link": -1,
                **meta,
                "color": _COLORS.get(name, [0.1, 0.55, 0.95, 1.0]),
                "data": base64.b64encode(q.tobytes()).decode("ascii"),
            }
        )
    anim_js = "null"
    if anim is not None:
        tf = np.asarray(anim["transforms"], np.float32)  # (S, L, 4, 4)
        s, l = tf.shape[0], tf.shape[1]
        # column-major per matrix for WebGL
        cm = np.ascontiguousarray(np.transpose(tf, (0, 1, 3, 2)).astype("<f4"))
        anim_js = json.dumps(
            {
                "frames": int(s),
                "links": int(l),
                "interval_ms": int(anim.get("interval_ms", 50)),
                "data": base64.b64encode(cm.tobytes()).decode("ascii"),
            }
        )
    html = (
        _TEMPLATE.replace("__TITLE__", title)
        .replace("__SCENE__", json.dumps(meshes))
        .replace("__ANIM__", anim_js)
    )
    with open(path, "w") as f:
        n = f.write(html)
    return n


def read_html_scene_summary(path: str) -> dict:
    """Parse the embedded scene back (test oracle): {name: {kind, link,
    verts, bbox_lo, bbox_hi}} with dequantized coordinate bounds, plus an
    "__anim__" entry when animation is embedded ({frames, links,
    transforms})."""
    with open(path) as f:
        html = f.read()
    start = html.index("/*SCENE*/") + len("/*SCENE*/")
    end = html.index("/*END*/")
    scene = json.loads(html[start:end])
    out = {}
    for m in scene:
        q = np.frombuffer(base64.b64decode(m["data"]), "<u2").reshape(-1, 3)
        pts = np.asarray(m["lo"]) + q.astype(np.float64) * np.asarray(m["scale"])
        out[m["name"]] = {
            "kind": m["kind"],
            "link": m.get("link", -1),
            "verts": int(q.shape[0]),
            "bbox_lo": pts.min(axis=0).tolist(),
            "bbox_hi": pts.max(axis=0).tolist(),
        }
    astart = html.index("/*ANIM*/") + len("/*ANIM*/")
    aend = html.index("/*ENDA*/")
    anim = json.loads(html[astart:aend])
    if anim is not None:
        raw = np.frombuffer(base64.b64decode(anim["data"]), "<f4")
        cm = raw.reshape(anim["frames"], anim["links"], 4, 4)
        out["__anim__"] = {
            "frames": anim["frames"],
            "links": anim["links"],
            "interval_ms": anim["interval_ms"],
            "transforms": np.transpose(cm, (0, 1, 3, 2)),  # back to row-major
        }
    return out


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
html,body{margin:0;height:100%;overflow:hidden;background:#181c22;font:12px system-ui,sans-serif}
#c{width:100%;height:100%;display:block}
#hud{position:fixed;left:10px;top:8px;color:#cdd3dc;user-select:none}
#hud b{color:#fff}
#bar{position:fixed;left:10px;bottom:10px;right:10px;display:none;align-items:center;gap:8px;color:#cdd3dc}
#bar input[type=range]{flex:1}
#bar button{background:#2b3340;color:#e8ecf2;border:1px solid #444;border-radius:4px;padding:3px 12px;cursor:pointer}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><b>__TITLE__</b> &mdash; drag: orbit &middot; wheel: zoom &middot; right/shift-drag: pan</div>
<div id="bar"><button id="play">&#9654;</button><input id="frame" type="range" min="0" value="0" step="1"><span id="ftxt"></span></div>
<script>
const SCENE=/*SCENE*/__SCENE__/*END*/;
const ANIM=/*ANIM*/__ANIM__/*ENDA*/;
const cv=document.getElementById("c");
const gl=cv.getContext("webgl",{antialias:true});
const VS=`attribute vec3 p;attribute vec3 n;uniform mat4 mvp;uniform mat3 nm;
varying vec3 vn;void main(){gl_Position=mvp*vec4(p,1.0);vn=nm*n;}`;
const FS=`precision mediump float;uniform vec4 col;uniform float lit;varying vec3 vn;
void main(){vec3 N=normalize(vn);float d=max(dot(N,normalize(vec3(0.5,0.7,1.0))),0.0)
+0.45*max(dot(N,normalize(vec3(-0.6,-0.2,-0.8))),0.0);
vec3 c=mix(col.rgb,col.rgb*(0.35+0.75*d),lit);gl_FragColor=vec4(c,col.a);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);gl.compileShader(o);
if(!gl.getShaderParameter(o,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const aP=gl.getAttribLocation(prog,"p"),aN=gl.getAttribLocation(prog,"n");
const uMVP=gl.getUniformLocation(prog,"mvp"),uNM=gl.getUniformLocation(prog,"nm");
const uCol=gl.getUniformLocation(prog,"col"),uLit=gl.getUniformLocation(prog,"lit");
function b64u16(s){const b=atob(s),u=new Uint8Array(b.length);
for(let i=0;i<b.length;i++)u[i]=b.charCodeAt(i);return new Uint16Array(u.buffer);}
function b64f32(s){const b=atob(s),u=new Uint8Array(b.length);
for(let i=0;i<b.length;i++)u[i]=b.charCodeAt(i);return new Float32Array(u.buffer);}
const TFS=ANIM?b64f32(ANIM.data):null;
let frame=0;
function linkMat(l){ // column-major 4x4 of link l at current frame
  if(!ANIM||l<0)return null;
  const o=(frame*ANIM.links+l)*16;return TFS.subarray(o,o+16);}
function mul44(a,b){const m=new Float32Array(16);
for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];m[c*4+r]=s;}return m;}
let lo=[1e30,1e30,1e30],hi=[-1e30,-1e30,-1e30];
const draws=[];
for(const m of SCENE){
  const q=b64u16(m.data);const nv=q.length/3;const pos=new Float32Array(q.length);
  for(let i=0;i<nv;i++)for(let a=0;a<3;a++)pos[i*3+a]=m.lo[a]+q[i*3+a]*m.scale[a];
  // scene bounds from frame-0 world positions
  const M=(ANIM&&m.link>=0)?TFS.subarray(m.link*16,m.link*16+16):null;
  for(let i=0;i<nv;i++){const x=pos[i*3],y=pos[i*3+1],z=pos[i*3+2];
    let wx=x,wy=y,wz=z;
    if(M){wx=M[0]*x+M[4]*y+M[8]*z+M[12];wy=M[1]*x+M[5]*y+M[9]*z+M[13];wz=M[2]*x+M[6]*y+M[10]*z+M[14];}
    for(const [a,v] of [[0,wx],[1,wy],[2,wz]]){if(v<lo[a])lo[a]=v;if(v>hi[a])hi[a]=v;}}
  const nrm=new Float32Array(q.length);
  if(m.kind==="mesh"){
    for(let t=0;t<nv/3;t++){const o=t*9;
      const ux=pos[o+3]-pos[o],uy=pos[o+4]-pos[o+1],uz=pos[o+5]-pos[o+2];
      const vx=pos[o+6]-pos[o],vy=pos[o+7]-pos[o+1],vz=pos[o+8]-pos[o+2];
      let nx=uy*vz-uz*vy,ny=uz*vx-ux*vz,nz=ux*vy-uy*vx;
      const l=Math.hypot(nx,ny,nz)||1;nx/=l;ny/=l;nz/=l;
      for(let k=0;k<3;k++){nrm[o+k*3]=nx;nrm[o+k*3+1]=ny;nrm[o+k*3+2]=nz;}}}
  const bp=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,bp);
  gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
  const bn=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,bn);
  gl.bufferData(gl.ARRAY_BUFFER,nrm,gl.STATIC_DRAW);
  draws.push({bp,bn,n:nv,mode:m.kind==="mesh"?gl.TRIANGLES:gl.LINE_STRIP,
              col:m.color,lit:m.kind==="mesh"?1:0,alpha:m.color[3]<1,link:m.link});}
draws.sort((a,b)=>(a.alpha?1:0)-(b.alpha?1:0)); // opaque first
const ctr=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
const rad=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2])||1;
let yaw=0.7,pitch=0.35,dist=rad*2.2,panX=0,panY=0;
function mat(){
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  const f=[cp*cy,cp*sy,sp];const r=[-sy,cy,0];
  const u=[-sp*cy,-sp*sy,cp];
  const eye=[ctr[0]-f[0]*dist+r[0]*panX+u[0]*panY,
             ctr[1]-f[1]*dist+r[1]*panX+u[1]*panY,
             ctr[2]-f[2]*dist+r[2]*panX+u[2]*panY];
  const tgt=[ctr[0]+r[0]*panX+u[0]*panY,ctr[1]+r[1]*panX+u[1]*panY,ctr[2]+r[2]*panX+u[2]*panY];
  const zx=eye[0]-tgt[0],zy=eye[1]-tgt[1],zz=eye[2]-tgt[2];
  let zl=Math.hypot(zx,zy,zz);const Z=[zx/zl,zy/zl,zz/zl];
  const X=[u[1]*Z[2]-u[2]*Z[1],u[2]*Z[0]-u[0]*Z[2],u[0]*Z[1]-u[1]*Z[0]];
  const xl=Math.hypot(...X);X[0]/=xl;X[1]/=xl;X[2]/=xl;
  const Y=[Z[1]*X[2]-Z[2]*X[1],Z[2]*X[0]-Z[0]*X[2],Z[0]*X[1]-Z[1]*X[0]];
  const tx=-(X[0]*eye[0]+X[1]*eye[1]+X[2]*eye[2]);
  const ty=-(Y[0]*eye[0]+Y[1]*eye[1]+Y[2]*eye[2]);
  const tz=-(Z[0]*eye[0]+Z[1]*eye[1]+Z[2]*eye[2]);
  const view=[X[0],Y[0],Z[0],0, X[1],Y[1],Z[1],0, X[2],Y[2],Z[2],0, tx,ty,tz,1];
  const asp=cv.width/cv.height,fov=0.9,near=rad*0.01,far=rad*20;
  const t=1/Math.tan(fov/2);
  const proj=[t/asp,0,0,0, 0,t,0,0, 0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0];
  return {vp:mul44(proj,view),R:[X,Y,Z]};}
function draw(){
  const dpr=window.devicePixelRatio||1;
  cv.width=cv.clientWidth*dpr;cv.height=cv.clientHeight*dpr;
  gl.viewport(0,0,cv.width,cv.height);
  gl.enable(gl.DEPTH_TEST);gl.clearColor(0.094,0.11,0.133,1);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  const {vp,R}=mat();
  for(const d of draws){
    if(d.alpha){gl.enable(gl.BLEND);gl.blendFunc(gl.SRC_ALPHA,gl.ONE_MINUS_SRC_ALPHA);gl.depthMask(false);}
    else{gl.disable(gl.BLEND);gl.depthMask(true);}
    const M=linkMat(d.link);
    const mvp=M?mul44(vp,M):vp;
    gl.uniformMatrix4fv(uMVP,false,mvp instanceof Float32Array?mvp:new Float32Array(mvp));
    // normal matrix = view rotation x model rotation
    let nm;
    if(M){nm=new Float32Array(9);
      for(let c=0;c<3;c++)for(let r=0;r<3;r++){let s=0;
        for(let k=0;k<3;k++)s+=R[r][k]*M[c*4+k];nm[c*3+r]=s;}}
    else{nm=new Float32Array([R[0][0],R[1][0],R[2][0],R[0][1],R[1][1],R[2][1],R[0][2],R[1][2],R[2][2]]);}
    gl.uniformMatrix3fv(uNM,false,nm);
    gl.bindBuffer(gl.ARRAY_BUFFER,d.bp);gl.enableVertexAttribArray(aP);
    gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER,d.bn);gl.enableVertexAttribArray(aN);
    gl.vertexAttribPointer(aN,3,gl.FLOAT,false,0,0);
    gl.uniform4fv(uCol,d.col);gl.uniform1f(uLit,d.lit);
    gl.lineWidth(2);gl.drawArrays(d.mode,0,d.n);}
  gl.depthMask(true);}
let drag=0,px=0,py=0;
cv.addEventListener("mousedown",e=>{drag=e.button===2||e.shiftKey?2:1;px=e.clientX;py=e.clientY;});
window.addEventListener("mouseup",()=>drag=0);
window.addEventListener("mousemove",e=>{if(!drag)return;
  const dx=e.clientX-px,dy=e.clientY-py;px=e.clientX;py=e.clientY;
  if(drag===1){yaw+=dx*0.008;pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*0.008));}
  else{panX-=dx*dist*0.0015;panY+=dy*dist*0.0015;}
  draw();});
cv.addEventListener("wheel",e=>{e.preventDefault();
  dist*=Math.exp(e.deltaY*0.001);dist=Math.min(rad*15,Math.max(rad*0.15,dist));draw();},{passive:false});
cv.addEventListener("contextmenu",e=>e.preventDefault());
window.addEventListener("resize",draw);
if(ANIM){
  const bar=document.getElementById("bar"),rng=document.getElementById("frame"),
        btn=document.getElementById("play"),txt=document.getElementById("ftxt");
  bar.style.display="flex";rng.max=ANIM.frames-1;
  function setf(f){frame=Math.max(0,Math.min(ANIM.frames-1,f|0));
    rng.value=frame;txt.textContent=(frame+1)+"/"+ANIM.frames;draw();}
  rng.addEventListener("input",()=>setf(+rng.value));
  let timer=null;
  btn.addEventListener("click",()=>{
    if(timer){clearInterval(timer);timer=null;btn.innerHTML="&#9654;";return;}
    btn.innerHTML="&#10074;&#10074;";
    timer=setInterval(()=>{ // the reference's 50 ms animation tick
      if(frame>=ANIM.frames-1){clearInterval(timer);timer=null;btn.innerHTML="&#9654;";return;}
      setf(frame+1);},ANIM.interval_ms);});
  setf(0);}
draw();
</script></body></html>
"""
