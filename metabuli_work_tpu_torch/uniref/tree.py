"""UniRef cluster tree: root -> UniRef50 -> UniRef90 -> UniRef100.

Reference: src/uniref/UnirefTree.{h,cpp} — parses UniRef100 XML (yxml
streaming parser; here xml.etree.iterparse) into a 4-level tree keyed by
cluster names, with LCA/ancestor ops used for k-mer label dedup and
classification voting.  Node 0 is the root; ids are dense.
"""

import xml.etree.ElementTree as ET

import numpy as np


class UnirefTree:
    def __init__(self, parent, names):
        self.parent = np.asarray(parent, dtype=np.int64)
        self.names = list(names)
        self.name2id = {n: i for i, n in enumerate(self.names) if n}

    # ------------------------------------------------------------------ #
    @classmethod
    def from_xml(cls, xml_path):
        """Parse UniRef100 XML: every <entry id="UniRef100_X"> carries
        'UniRef90 ID' and 'UniRef50 ID' properties."""
        parent = [0]
        names = ["root"]
        idx = {}

        def get(name, par):
            if name in idx:
                return idx[name]
            i = len(names)
            names.append(name)
            parent.append(par)
            idx[name] = i
            return i

        # strip namespaces during iterparse
        for event, elem in ET.iterparse(xml_path, events=("end",)):
            tag = elem.tag.rsplit("}", 1)[-1]
            if tag != "entry":
                continue
            u100 = elem.get("id", "")
            u90 = u50 = None
            for prop in elem.iter():
                ptag = prop.tag.rsplit("}", 1)[-1]
                if ptag == "property":
                    t = prop.get("type")
                    if t == "UniRef90 ID":
                        u90 = prop.get("value")
                    elif t == "UniRef50 ID":
                        u50 = prop.get("value")
            i50 = get(u50, 0) if u50 else 0
            i90 = get(u90, i50) if u90 else i50
            if u100:
                get(u100, i90)
            elem.clear()
        return cls(parent, names)

    def save(self, path):
        np.savez_compressed(path, parent=self.parent,
                            names=np.array(self.names, dtype=object))

    @classmethod
    def load(cls, path):
        z = np.load(path, allow_pickle=True)
        return cls(z["parent"], [str(s) for s in z["names"]])

    # ------------------------------------------------------------------ #
    def _chain(self, i):
        out = [int(i)]
        while out[-1] != 0:
            out.append(int(self.parent[out[-1]]))
        return out

    def is_ancestor(self, anc, node):
        anc, node = int(anc), int(node)
        while True:
            if node == anc:
                return True
            if node == 0:
                return False
            node = int(self.parent[node])

    def lca_pair(self, a, b):
        ca = set(self._chain(a))
        node = int(b)
        while node not in ca:
            node = int(self.parent[node])
        return node

    def lca_list(self, ids):
        ids = [int(i) for i in ids if int(i) > 0]
        if not ids:
            return 0
        acc = ids[0]
        for t in ids[1:]:
            acc = self.lca_pair(acc, t)
        return acc

    def name_of(self, i):
        return self.names[int(i)] if 0 <= int(i) < len(self.names) else "-"

    def __len__(self):
        return len(self.names)
