"""Result writers: per-read TSV, Kraken-style report, Krona HTML.

Formats follow the reference Reporter (src/commons/Reporter.cpp:38-253;
column documentation README.md:195-235):

  <job>_classifications.tsv
    #is_classified name taxID query_length score rank [lineage] taxID:match_count
    (taxids printed in ORIGINAL id space; unclassified rows use '-')
  <job>_report.tsv
    clade_proportion clade_count taxon_count rank taxID name (2-space
    indent per depth); first row = unclassified; children sorted by
    descending clade count
  <job>_krona.html
    nested <node name=...><magnitude> XML (identical payload to the
    reference's Reporter::kronaReport) rendered by an embedded
    self-contained zoomable SVG sunburst (the reference prepends the
    vendored KronaTools prelude instead, Reporter.cpp:219)
"""

import os
from typing import Dict, List

from ..classify.pipeline import QueryRecord
from ..taxonomy import Taxonomy


def _fmt_score(x: float) -> str:
    """C++ ostream default formatting for floats (6 significant digits)."""
    s = f"{x:.6g}"
    return s


def write_classifications(path, records: List[QueryRecord], taxonomy: Taxonomy,
                          print_lineage: bool = False, group_ids=None):
    with open(path, "w") as f:
        header = "#is_classified\tname\ttaxID\tquery_length\tscore\trank"
        if group_ids is not None:
            header += "\tgroup"
        if print_lineage:
            header += "\tlineage"
        header += "\ttaxID:match_count\n"
        f.write(header)
        for i, qr in enumerate(records):
            r = qr.result
            cls = 1 if r.is_classified else 0
            orig = taxonomy.orig_of(r.classification)
            cols = [str(cls), qr.name, str(orig), str(qr.covered_length), _fmt_score(r.score)]
            if r.is_classified:
                cols.append(taxonomy.rank_of(r.classification))
            else:
                cols.append("-")
            if group_ids is not None:
                g = group_ids[i]
                cols.append(str(g) if g else "-")
            if print_lineage:
                cols.append(_lineage(taxonomy, r.classification) if r.is_classified else "-")
            if r.is_classified:
                # classified rows end "taxid:cnt taxid:cnt \n"; unclassified
                # rows end "-\t\n" (reference Reporter.cpp:64-81)
                cnts = "".join(f"{taxonomy.orig_of(t)}:{c} " for t, c in sorted(r.tax_cnt.items()))
                f.write("\t".join(cols) + "\t" + cnts + "\n")
            else:
                f.write("\t".join(cols) + "\t-\t\n")


def _lineage(taxonomy: Taxonomy, taxid: int) -> str:
    chain = []
    node = int(taxid)
    while node > 1:
        chain.append(taxonomy.name_of(node))
        node = int(taxonomy.parent[node])
    return ";".join(reversed(chain))


def compute_clade_counts(tax_counts: Dict[int, int], taxonomy: Taxonomy):
    """taxid -> (taxon_count, clade_count, children list)."""
    clade: Dict[int, int] = {}
    taxon: Dict[int, int] = {}
    children: Dict[int, List[int]] = {}
    for t, c in tax_counts.items():
        if t <= 0:
            continue
        taxon[t] = taxon.get(t, 0) + c
        node = t
        while True:
            clade[node] = clade.get(node, 0) + c
            par = int(taxonomy.parent[node])
            if par == node:
                break
            if node not in children.setdefault(par, []):
                children[par].append(node)
            node = par
    return taxon, clade, children


def write_report(path, tax_counts: Dict[int, int], total_reads: int, taxonomy: Taxonomy):
    taxon, clade, children = compute_clade_counts(tax_counts, taxonomy)
    unclassified = tax_counts.get(0, 0)
    with open(path, "w") as f:
        f.write("#clade_proportion\tclade_count\ttaxon_count\trank\ttaxID\tname\n")
        if unclassified > 0:
            f.write(f"{100.0 * unclassified / max(total_reads, 1):.4f}\t{unclassified}\t{unclassified}\tno rank\t0\tunclassified\n")

        def emit(node, depth):
            cc = clade.get(node, 0)
            if cc == 0:
                return
            tc = taxon.get(node, 0)
            f.write(
                f"{100.0 * cc / max(total_reads, 1):.4f}\t{cc}\t{tc}\t"
                f"{taxonomy.rank_of(node)}\t{taxonomy.orig_of(node)}\t"
                f"{'  ' * depth}{taxonomy.name_of(node)}\n"
            )
            ch = sorted(children.get(node, []), key=lambda c: -clade.get(c, 0))
            for c in ch:
                emit(c, depth + 1)

        if clade:
            emit(taxonomy.root, 0)


# The reference ships an interactive chart by prepending the KronaTools
# prelude blob (Reporter.cpp:219 `krona_prelude_html`; the blob itself
# lives in the absent mmseqs submodule).  Equivalent here: the SAME
# nested <node> XML payload (golden-diffable against the binary's)
# inside a hidden div, rendered by a small self-contained zoomable SVG
# sunburst (no external fetches — the file works offline).
_KRONA_HEADER = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Krona chart</title>
<style>
body{font-family:sans-serif;background:#fff;margin:0}
#chart{display:flex}
#legend{padding:12px;font-size:13px;max-width:320px;overflow:auto;height:95vh}
#legend div{cursor:pointer;padding:1px 4px;border-radius:3px;white-space:nowrap}
#legend div:hover{background:#eee}
#tip{position:fixed;pointer-events:none;background:#222;color:#fff;
     padding:4px 8px;border-radius:4px;font-size:12px;display:none;z-index:9}
path{stroke:#fff;stroke-width:.7;cursor:pointer}
path:hover{opacity:.82}
path.dim{opacity:.18}
text.lbl{font-size:11px;pointer-events:none;fill:#222}
#crumb{font-size:13px;padding:6px 12px;color:#444}
#crumb span{cursor:pointer;color:#06c}
#ctl{font-size:12px;padding:4px 12px;color:#444;display:flex;gap:14px;
     align-items:center;flex-wrap:wrap}
#ctl input[type=text]{width:160px}
#hits{font-size:12px;padding:0 12px;color:#06c;max-height:60px;overflow:auto}
#hits span{cursor:pointer;margin-right:10px}
</style></head>
<body><div style="display:none" id="krona"><krona>
"""

_KRONA_SCRIPT = """
<div id="ctl">
  <label>search <input type="text" id="q" placeholder="taxon name"></label>
  <label>collapse &lt; <select id="thr">
    <option value="0">off</option><option value="0.001" selected>0.1%</option>
    <option value="0.005">0.5%</option><option value="0.01">1%</option>
    <option value="0.05">5%</option></select></label>
  <label>depth <select id="dep">
    <option>3</option><option>5</option><option selected>7</option>
    <option>10</option><option>15</option></select></label>
  <label>magnitude <select id="mag">
    <option value="lin" selected>linear</option>
    <option value="sqrt">sqrt</option>
    <option value="log">log</option></select></label>
</div>
<div id="crumb"></div><div id="hits"></div>
<div id="chart"><svg id="sb" width="760" height="760"
viewBox="-380 -380 760 760"></svg><div id="legend"></div></div>
<div id="tip"></div>
<script>
(function(){
"use strict";
function parse(el,par){
  var val=0, kids=[];
  var n={name:el.getAttribute("name")||"?", val:0, kids:kids, par:par};
  for(var c=el.firstElementChild;c;c=c.nextElementSibling){
    if(c.tagName.toLowerCase()==="magnitude"){
      var v=c.querySelector("val"); if(v) val=+v.textContent;
    } else if(c.tagName.toLowerCase()==="node") kids.push(parse(c,n));
  }
  n.val=val;
  return n;
}
var rootEl=document.querySelector("#krona node");
if(!rootEl) return;
var root=parse(rootEl,null);
function hue(s){var h=0;for(var i=0;i<s.length;i++)h=(h*31+s.charCodeAt(i))>>>0;return h%360;}
var svg=document.getElementById("sb"), tip=document.getElementById("tip"),
    legend=document.getElementById("legend"), crumb=document.getElementById("crumb"),
    qEl=document.getElementById("q"), thrEl=document.getElementById("thr"),
    depEl=document.getElementById("dep"), magEl=document.getElementById("mag"),
    hitsEl=document.getElementById("hits");
var R=370, total=root.val||1, trail=[root], cur=root;
function arcPath(a0,a1,r0,r1){
  if(a1-a0>=2*Math.PI-1e-6){a1=a0+2*Math.PI-1e-6;}
  var c=function(a,r){return [r*Math.sin(a), -r*Math.cos(a)];};
  var p0=c(a0,r0),p1=c(a1,r0),p2=c(a1,r1),p3=c(a0,r1),
      big=(a1-a0)>Math.PI?1:0;
  return "M"+p0+"A"+r0+","+r0+" 0 "+big+" 1 "+p1+"L"+p2+
         "A"+r1+","+r1+" 0 "+big+" 0 "+p3+"Z";
}
function esc(s){return s.replace(/&/g,"&amp;").replace(/</g,"&lt;");}
// magnitude transform: arc ANGLES only — displayed counts stay raw
// (KronaTools' linear/sqrt/log magnitude options)
function tf(v){
  var m=magEl.value;
  if(v<=0) return 0;
  if(m==="sqrt") return Math.sqrt(v);
  if(m==="log") return Math.log(1+v);
  return v;
}
function matches(n,q){return q && n.name.toLowerCase().indexOf(q)>=0;}
function render(node){
  cur=node;
  var ti=trail.indexOf(node);
  if(ti>=0){trail=trail.slice(0,ti+1);}
  else if(node.par && trail[trail.length-1]===node.par){trail.push(node);}
  else{trail=[];for(var t=node;t;t=t.par)trail.unshift(t);}
  var DEPTH=+depEl.value, thr=+thrEl.value, q=qEl.value.trim().toLowerCase();
  var parts=[], leg=[], mag=node.val||1;
  var rw=R/(DEPTH+1);
  function rec(n,a0,a1,d,h){
    if(d>DEPTH||(a1-a0)<0.002) return;
    var hh=(h===null)?hue(n.name):h;
    var col=n.other?"hsl(0,0%,72%)":
      "hsl("+hh+","+(62-6*Math.min(d,4))+"%,"+(52+5*Math.min(d,4))+"%)";
    parts.push({n:n,a0:a0,a1:a1,d:d,col:col});
    if(d===1) leg.push({n:n,col:col});
    // collapse: children below thr of the CURRENT root merge into one
    // gray "other" wedge (KronaTools' collapse threshold)
    var kids=n.kids, small=[], big=[];
    kids.forEach(function(k){
      (thr>0 && k.val<thr*mag && kids.length>1 ? small : big).push(k);
    });
    if(small.length>1){
      var sv=0; small.forEach(function(k){sv+=k.val;});
      big=big.concat([{name:"other ("+small.length+" taxa)",val:sv,
                       kids:[],par:n,other:true,members:small}]);
    } else big=kids;
    var a=a0, sum=0;
    big.forEach(function(k){sum+=tf(k.val);});
    var rem=n.val; big.forEach(function(k){rem-=k.val;});
    var scale=(a1-a0)/Math.max(sum+tf(Math.max(rem,0)),1e-9);
    big.forEach(function(k){
      var w=tf(k.val)*scale; rec(k,a,a+w,d+1,(d===0)?null:hh); a+=w;
    });
  }
  rec(node,0,2*Math.PI,0,null);
  var s="";
  parts.forEach(function(p,i){
    var r0=(p.d===0)?0:rw*p.d, r1=rw*(p.d+1)-1;
    var dim=q&&!p.n.other&&!matches(p.n,q)?' class="dim"':'';
    s+='<path d="'+arcPath(p.a0,p.a1,r0,r1)+'" fill="'+p.col+'"'+dim+
       ' data-i="'+i+'"/>';
    var frac=(p.a1-p.a0)/(2*Math.PI);
    if(frac>0.04&&p.d>0&&p.d<4){
      var am=(p.a0+p.a1)/2, rm=(r0+r1)/2;
      s+='<text class="lbl" text-anchor="middle" x="'+(rm*Math.sin(am)).toFixed(1)+
         '" y="'+(-rm*Math.cos(am)).toFixed(1)+'">'+esc(p.n.name.slice(0,18))+"</text>";
    }
  });
  s+='<text text-anchor="middle" y="-4" font-size="15">'+esc(node.name)+"</text>"+
     '<text text-anchor="middle" y="16" font-size="12" fill="#666">'+node.val+" reads</text>";
  svg.innerHTML=s;
  svg.querySelectorAll("path").forEach(function(el){
    var p=parts[+el.dataset.i];
    el.onmousemove=function(e){
      tip.style.display="block";tip.style.left=(e.clientX+12)+"px";
      tip.style.top=(e.clientY+12)+"px";
      tip.innerHTML=esc(p.n.name)+"<br>"+p.n.val+" reads ("+
        (100*p.n.val/total).toFixed(2)+"% of all, "+
        (100*p.n.val/mag).toFixed(2)+"% of "+esc(node.name)+")";
    };
    el.onmouseout=function(){tip.style.display="none";};
    el.onclick=function(){
      if(p.n.other){return;}
      if(p.n!==node&&p.n.kids.length)render(p.n);
    };
  });
  legend.innerHTML=leg.map(function(l,i){
    return '<div data-i="'+i+'"><span style="color:'+l.col+'">&#9632;</span> '+
      esc(l.n.name)+" ("+l.n.val+")</div>";
  }).join("");
  legend.querySelectorAll("div").forEach(function(el){
    el.onclick=function(){var t=leg[+el.dataset.i].n;
      if(!t.other&&t.kids.length)render(t);};
  });
  crumb.innerHTML=trail.map(function(t,i){
    return '<span data-i="'+i+'">'+esc(t.name)+"</span>";
  }).join(" &rsaquo; ");
  crumb.querySelectorAll("span").forEach(function(el){
    el.onclick=function(){render(trail[+el.dataset.i]);};
  });
  // search hit list over the WHOLE tree, click to zoom
  var hits=[];
  if(q){(function walk(n){
    if(matches(n,q)) hits.push(n);
    if(hits.length<200) n.kids.forEach(walk);
  })(root);}
  hitsEl.innerHTML=hits.slice(0,30).map(function(h,i){
    return '<span data-i="'+i+'">'+esc(h.name)+" ("+h.val+")</span>";
  }).join("")+(hits.length>30?" &hellip;"+hits.length+" matches":"");
  hitsEl.querySelectorAll("span").forEach(function(el){
    el.onclick=function(){var t=hits[+el.dataset.i];
      render(t.kids.length?t:(t.par||root));};
  });
}
[thrEl,depEl,magEl].forEach(function(el){el.onchange=function(){render(cur);};});
qEl.oninput=function(){render(cur);};
render(root);
})();
</script>"""


def _escape(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;").replace('"', "&quot;")


def write_krona(path, tax_counts: Dict[int, int], total_reads: int, taxonomy: Taxonomy):
    taxon, clade, children = compute_clade_counts(tax_counts, taxonomy)
    unclassified = tax_counts.get(0, 0)
    with open(path, "w") as f:
        f.write(_KRONA_HEADER)
        f.write(f'<node name="all"><magnitude><val>{total_reads}</val></magnitude>')
        if unclassified > 0:
            f.write(f'<node name="unclassified"><magnitude><val>{unclassified}</val></magnitude></node>')

        def emit(node):
            cc = clade.get(node, 0)
            if cc == 0:
                return
            f.write(f'<node name="{_escape(taxonomy.name_of(node))}"><magnitude><val>{cc}</val></magnitude>')
            for c in sorted(children.get(node, []), key=lambda c: -clade.get(c, 0)):
                emit(c)
            f.write("</node>")

        if clade:
            emit(taxonomy.root)
        f.write("</node></krona></div>")
        f.write(_KRONA_SCRIPT)
        f.write("</body></html>")


def aggregate_tax_counts(records: List[QueryRecord]) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for qr in records:
        t = qr.result.classification if qr.result and qr.result.is_classified else 0
        counts[t] = counts.get(t, 0) + 1
    return counts


def write_all(out_dir, job_id, records, taxonomy, print_lineage=False):
    os.makedirs(out_dir, exist_ok=True)
    cls_path = os.path.join(out_dir, f"{job_id}_classifications.tsv")
    rpt_path = os.path.join(out_dir, f"{job_id}_report.tsv")
    krona_path = os.path.join(out_dir, f"{job_id}_krona.html")
    write_classifications(cls_path, records, taxonomy, print_lineage)
    counts = aggregate_tax_counts(records)
    write_report(rpt_path, counts, len(records), taxonomy)
    write_krona(krona_path, counts, len(records), taxonomy)
    return cls_path, rpt_path, krona_path
