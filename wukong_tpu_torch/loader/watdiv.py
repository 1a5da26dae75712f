"""WatDiv-family dataset synthesizer (id-triples native) + template queries.

The eval ladder (BASELINE.json) includes WatDiv-1B star/snowflake templates
S1-S7 / F1-F5. Like loader/lubm.py, this synthesizes the dataset directly in id
space with a deterministic formulaic layout and a virtual string backend, at the
cardinality ratios of the WatDiv e-commerce schema (users, products, reviews,
retailers, genres, cities/countries, tags):

  scale N ~ "products": products = 25*N, users = 100*N, reviews = 150*N,
  retailers = N/10+1, websites = N/5+1, genres = 21, cities = 240,
  countries = 25, tags = 10*N^0.6-ish (pool).

Predicates cover the S/F template families: rdf:type, wsdbm:likes,
wsdbm:friendOf, wsdbm:follows, wsdbm:makesPurchase, wsdbm:purchaseFor,
wsdbm:hasGenre, rev:hasReview, rev:reviewer, sorg:caption, sorg:contentRating,
sorg:language, gr:offers, og:tag, sorg:nationality, mo:artist,
wsdbm:subscribes, dc:Location, foaf:homepage.

The port's copy of the JAX package's loader/watdiv.py: the same (scale,
seed) gives the same triples and ids, and ``write_dataset`` writes the same
directory, byte for byte.
"""

from __future__ import annotations

import json
import os

import numpy as np

from wukong_tpu_torch.types import NORMAL_ID_START, PREDICATE_ID, TYPE_ID

WSDBM = "http://db.uwaterloo.ca/~galuc/wsdbm/"
RDF_TYPE_STR = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"

PRED_NAMES = [
    ("likes", f"{WSDBM}likes"),
    ("friendOf", f"{WSDBM}friendOf"),
    ("follows", f"{WSDBM}follows"),
    ("makesPurchase", f"{WSDBM}makesPurchase"),
    ("purchaseFor", f"{WSDBM}purchaseFor"),
    ("hasReview", "http://purl.org/stuff/rev#hasReview"),
    ("reviewer", "http://purl.org/stuff/rev#reviewer"),
    ("caption", "http://schema.org/caption"),
    ("contentRating", "http://schema.org/contentRating"),
    ("language", "http://schema.org/language"),
    ("offers", "http://purl.org/goodrelations/offers"),
    ("hasGenre", f"{WSDBM}hasGenre"),
    ("tag", "http://ogp.me/ns#tag"),
    ("nationality", "http://schema.org/nationality"),
    ("artist", "http://purl.org/ontology/mo/artist"),
    ("subscribes", f"{WSDBM}subscribes"),
    ("location", "http://purl.org/dc/terms/Location"),
    ("homepage", "http://xmlns.com/foaf/homepage"),
]
TYPE_NAMES = ["User", "Product", "Review", "Retailer", "Website", "Genre",
              "City", "Country", "Tag", "Offer", "Language", "Caption",
              "Rating"]

P = {name: 2 + i for i, (name, _uri) in enumerate(PRED_NAMES)}
T = {name: 2 + len(PRED_NAMES) + i for i, name in enumerate(TYPE_NAMES)}
NGENRE, NCITY, NCOUNTRY, NLANG, NRATING = 21, 240, 25, 12, 45


def index_strings():
    rows = [("__PREDICATE__", PREDICATE_ID), (RDF_TYPE_STR, TYPE_ID)]
    for (name, uri) in PRED_NAMES:
        rows.append((f"<{uri}>", P[name]))
    for name in TYPE_NAMES:
        rows.append((f"<{WSDBM}{name}>", T[name]))
    return rows


class WatdivLayout:
    def __init__(self, scale: int, seed: int = 0):
        self.scale = scale
        self.seed = seed
        self.n_product = 25 * scale
        self.n_user = 100 * scale
        self.n_review = 150 * scale
        self.n_retailer = scale // 10 + 1
        self.n_website = scale // 5 + 1
        self.n_offer = 90 * scale
        self.n_tag = max(int(10 * scale ** 0.6), 16)
        cur = NORMAL_ID_START
        for name, n in [("product", self.n_product), ("user", self.n_user),
                        ("review", self.n_review), ("retailer", self.n_retailer),
                        ("website", self.n_website), ("offer", self.n_offer),
                        ("tag", self.n_tag), ("genre", NGENRE),
                        ("city", NCITY), ("country", NCOUNTRY),
                        ("language", NLANG), ("rating", NRATING),
                        ("caption", self.n_product)]:
            setattr(self, f"{name}_base", cur)
            setattr(self, f"n_{name}", n)
            cur += n
        self.id_end = cur

    _CLASSES = [("product", "Product"), ("user", "User"), ("review", "Review"),
                ("retailer", "Retailer"), ("website", "Website"),
                ("offer", "Offer"), ("tag", "Tag"), ("genre", "Genre"),
                ("city", "City"), ("country", "Country"),
                ("language", "Language"), ("caption", "Caption"),
                ("rating", "Rating")]

    def class_of(self, vid: int):
        for name, cls in self._CLASSES:
            base = getattr(self, f"{name}_base")
            if base <= vid < base + getattr(self, f"n_{name}"):
                return name, cls, vid - base
        return None


def generate_watdiv(scale: int, seed: int = 0):
    """Returns ([M,3] int64 triples, WatdivLayout). Deterministic."""
    lay = WatdivLayout(scale, seed)
    rng = np.random.Generator(np.random.PCG64([seed, 7]))
    S, Pr, O = [], [], []

    def emit(s, p, o):
        s = np.asarray(s, dtype=np.int64)
        o = np.asarray(o, dtype=np.int64)
        S.append(s)
        Pr.append(np.full(len(s), p, dtype=np.int64))
        O.append(o)

    prod = lay.product_base + np.arange(lay.n_product)
    user = lay.user_base + np.arange(lay.n_user)
    rev = lay.review_base + np.arange(lay.n_review)
    ret = lay.retailer_base + np.arange(lay.n_retailer)
    web = lay.website_base + np.arange(lay.n_website)
    offer = lay.offer_base + np.arange(lay.n_offer)
    tag = lay.tag_base + np.arange(lay.n_tag)
    genre = lay.genre_base + np.arange(NGENRE)
    city = lay.city_base + np.arange(NCITY)
    country = lay.country_base + np.arange(NCOUNTRY)
    lang = lay.language_base + np.arange(NLANG)
    rating = lay.rating_base + np.arange(NRATING)
    capt = lay.caption_base + np.arange(lay.n_product)

    for arr, t in [(prod, "Product"), (user, "User"), (rev, "Review"),
                   (ret, "Retailer"), (web, "Website"), (offer, "Offer"),
                   (tag, "Tag"), (genre, "Genre"), (city, "City"),
                   (country, "Country"), (lang, "Language"),
                   (rating, "Rating")]:
        emit(arr, TYPE_ID, np.full(len(arr), T[t]))

    # products: genre (zipf-ish skew), caption, language, rating, tags 0-4
    gz = np.minimum((rng.pareto(1.2, lay.n_product)).astype(np.int64), NGENRE - 1)
    emit(prod, P["hasGenre"], genre[gz])
    emit(prod, P["artist"], lay.user_base + rng.integers(0, lay.n_user, lay.n_product))
    emit(prod, P["caption"], capt)
    emit(prod, P["language"], lang[rng.integers(0, NLANG, lay.n_product)])
    emit(prod, P["contentRating"], lay.rating_base + rng.integers(0, NRATING, lay.n_product))
    emit(prod, P["tag"], tag[rng.integers(0, lay.n_tag, lay.n_product)])
    ntags2 = rng.integers(0, 4, lay.n_product)
    rep = np.repeat(prod, ntags2)
    emit(rep, P["tag"], tag[rng.integers(0, lay.n_tag, len(rep))])

    # users: likes 0-10 products, friendOf 0-20, follows 0-8, city, country
    nl = rng.integers(0, 11, lay.n_user)
    ru = np.repeat(user, nl)
    emit(ru, P["likes"], prod[rng.integers(0, lay.n_product, len(ru))])
    nf = rng.integers(0, 21, lay.n_user)
    rf = np.repeat(user, nf)
    emit(rf, P["friendOf"], user[rng.integers(0, lay.n_user, len(rf))])
    nfo = rng.integers(0, 9, lay.n_user)
    rfo = np.repeat(user, nfo)
    emit(rfo, P["follows"], user[rng.integers(0, lay.n_user, len(rfo))])
    emit(user, P["location"], city[rng.integers(0, NCITY, lay.n_user)])
    emit(user, P["nationality"], country[rng.integers(0, NCOUNTRY, lay.n_user)])
    nsub = rng.integers(0, 3, lay.n_user)
    rs = np.repeat(user, nsub)
    emit(rs, P["subscribes"], web[rng.integers(0, lay.n_website, len(rs))])
    # purchases
    npur = rng.integers(0, 6, lay.n_user)
    rp = np.repeat(user, npur)
    emit(rp, P["makesPurchase"], prod[rng.integers(0, lay.n_product, len(rp))])

    # reviews: each reviews one product, has a reviewer and a rating
    rev_prod = prod[rng.integers(0, lay.n_product, lay.n_review)]
    emit(rev_prod, P["hasReview"], rev)
    emit(rev, P["reviewer"], user[rng.integers(0, lay.n_user, lay.n_review)])
    emit(rev, P["contentRating"], lay.rating_base + rng.integers(0, NRATING, lay.n_review))

    # offers: retailer offers product (with validThrough a city?? no — plain)
    off_prod = prod[rng.integers(0, lay.n_product, lay.n_offer)]
    off_ret = ret[rng.integers(0, lay.n_retailer, lay.n_offer)]
    emit(off_ret, P["offers"], offer)
    emit(offer, P["purchaseFor"], off_prod)
    # websites: homepage of retailers, hits
    emit(ret, P["homepage"], web[rng.integers(0, lay.n_website, lay.n_retailer)])
    # cities in countries
    emit(city, P["location"], country[rng.integers(0, NCOUNTRY, NCITY)])

    triples = np.stack([np.concatenate(S), np.concatenate(Pr),
                        np.concatenate(O)], axis=1)
    # drop duplicate triples (random with-replacement draws can repeat a pair;
    # the store dedups on insert, so the raw array must match)
    triples = np.unique(triples, axis=0)
    return triples, lay


_ENTITY_RE = None


def _entity_re():
    global _ENTITY_RE
    if _ENTITY_RE is None:
        import re

        _ENTITY_RE = re.compile(rf"<{WSDBM}([A-Za-z]+)(\d+)>")
    return _ENTITY_RE


class VirtualWatdivStrings:
    """O(1)-memory string<->id mapping for a synthesized WatDiv dataset."""

    def __init__(self, scale: int, seed: int = 0):
        self.lay = WatdivLayout(scale, seed)
        rows = index_strings()
        self._s2i = {s: i for s, i in rows}
        self._i2s = {i: s for s, i in rows}
        self.pid2type = {}

    def str2id(self, s: str) -> int:
        if s in self._s2i:
            return self._s2i[s]
        m = _entity_re().fullmatch(s)
        if m:
            cls, k = m.group(1), int(m.group(2))
            name = cls.lower()
            base = getattr(self.lay, f"{name}_base", None)
            n = getattr(self.lay, f"n_{name}", 0)
            if base is not None and k < n:
                return base + k
        raise KeyError(s)

    def id2str(self, i: int) -> str:
        if i in self._i2s:
            return self._i2s[i]
        info = self.lay.class_of(int(i))
        if info is None:
            raise KeyError(i)
        name, cls, k = info
        return f"<{WSDBM}{cls}{k}>"

    def exist(self, s: str) -> bool:
        try:
            self.str2id(s)
            return True
        except KeyError:
            return False

    def exist_id(self, i: int) -> bool:
        try:
            self.id2str(i)
            return True
        except KeyError:
            return False


# ---------------------------------------------------------------------------
# S/F template queries (star + snowflake families; %placeholders like LUBM)
# ---------------------------------------------------------------------------

TEMPLATES = {
    # stars (S family): multiple predicates around one entity
    "S1": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?p ?cap ?lang ?tg WHERE {{
        ?p <http://schema.org/caption> ?cap .
        ?p <http://schema.org/language> ?lang .
        ?p <http://ogp.me/ns#tag> ?tg .
        ?p <http://schema.org/contentRating> %wsdbm:Rating .
    }}""",
    "S2": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?u ?city WHERE {{
        ?u <http://purl.org/dc/terms/Location> ?city .
        ?u <http://schema.org/nationality> %wsdbm:Country .
        ?u <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> wsdbm:User .
    }}""",
    "S3": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?offer ?prod WHERE {{
        %wsdbm:Retailer <http://purl.org/goodrelations/offers> ?offer .
        ?offer wsdbm:purchaseFor ?prod .
    }}""",
    "S4": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?u ?web WHERE {{
        ?u wsdbm:subscribes ?web .
        ?u <http://schema.org/nationality> %wsdbm:Country .
    }}""",
    # snowflakes (F family): chained stars
    "F1": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?rev ?who ?city WHERE {{
        %wsdbm:Product <http://purl.org/stuff/rev#hasReview> ?rev .
        ?rev <http://purl.org/stuff/rev#reviewer> ?who .
        ?who <http://purl.org/dc/terms/Location> ?city .
    }}""",
    "F2": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?f ?p ?lang WHERE {{
        %wsdbm:User wsdbm:friendOf ?f .
        ?f wsdbm:likes ?p .
        ?p <http://schema.org/language> ?lang .
    }}""",
    "F3": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?offer ?prod ?rev WHERE {{
        %wsdbm:Retailer <http://purl.org/goodrelations/offers> ?offer .
        ?offer wsdbm:purchaseFor ?prod .
        ?prod <http://purl.org/stuff/rev#hasReview> ?rev .
    }}""",
    "S5": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?p ?cap ?g WHERE {{
        ?p <http://schema.org/caption> ?cap .
        ?p wsdbm:hasGenre %wsdbm:Genre .
        ?p <http://schema.org/language> ?g .
    }}""",
    "S6": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?p ?artist WHERE {{
        ?p <http://purl.org/ontology/mo/artist> ?artist .
        ?p wsdbm:hasGenre %wsdbm:Genre .
    }}""",
    "S7": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?u ?pur WHERE {{
        ?u wsdbm:makesPurchase ?pur .
        ?u <http://schema.org/nationality> %wsdbm:Country .
        ?u <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> wsdbm:User .
    }}""",
    "F4": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?f ?fof ?p WHERE {{
        %wsdbm:User wsdbm:friendOf ?f .
        ?f wsdbm:friendOf ?fof .
        ?fof wsdbm:likes ?p .
    }}""",
    "F5": f"""PREFIX wsdbm: <{WSDBM}>
    SELECT ?rev ?who ?country WHERE {{
        %wsdbm:Product <http://purl.org/stuff/rev#hasReview> ?rev .
        ?rev <http://purl.org/stuff/rev#reviewer> ?who .
        ?who <http://schema.org/nationality> ?country .
    }}""",
}


def write_dataset(outdir: str, scale: int, seed: int = 0,
                  chunk_rows: int | None = None) -> dict:
    """Write an id-format WatDiv dataset. `chunk_rows` splits the triple
    array over multiple ``id_triples_<k>.npy`` files; the reader
    (loader/base.py) preallocates and fills per chunk, so its transient
    peak is one chunk above the dataset (the generator itself is a
    vectorized in-RAM build either way)."""
    os.makedirs(outdir, exist_ok=True)
    triples, lay = generate_watdiv(scale, seed)
    if chunk_rows:
        for k in range(0, len(triples), chunk_rows):
            np.save(os.path.join(outdir, f"id_triples_{k // chunk_rows:05d}.npy"),
                    triples[k:k + chunk_rows])
    else:
        np.save(os.path.join(outdir, "id_triples.npy"), triples)
    with open(os.path.join(outdir, "str_index"), "w") as f:
        for s, i in index_strings():
            f.write(f"{s}\t{i}\n")
    meta = {"generator": "watdiv", "scale": scale, "seed": seed,
            "num_triples": int(len(triples))}
    with open(os.path.join(outdir, "str_normal_virtual"), "w") as f:
        json.dump(meta, f)
    qdir = os.path.join(outdir, "queries")
    os.makedirs(qdir, exist_ok=True)
    for name, text in TEMPLATES.items():
        with open(os.path.join(qdir, name), "w") as f:
            f.write(text)
    return meta
