"""The port's distributed engine (device="cpu") against the JAX package's
DistEngine on its 8-device virtual CPU mesh: the shape cases of
tests/test_dist_engine.py — OPTIONAL (a dedup-seeded distributed child and
the host left join), UNION (seeded distributed children), FILTER in
branches and groups, attributes on the subject owner, variable
predicates, and blind replies of every shape. Rows (as multisets, with
attribute values), status, ``complete`` and the last chain's stats equal
JAX's. Texts after Wukong's LUBM optional, union and attr suites
(scripts/sparql_query/lubm/{optional,union,attr} upstream).
"""

import pytest

import chip_smoke
from test_torch_dist_engine import (  # noqa: F401 (fixtures)
    DEPT0,
    PREFIX,
    World,
    _pin_collective_route,
    check_text,
    run_text,
    same,
    world,
)
from wukong_tpu.config import Global as JG

EXT = chip_smoke.EXT_QUERIES
UNIV0 = chip_smoke.UNIV0

OPTIONAL = {
    "light": EXT["x_opt_light"],
    "heavy": EXT["x_opt_heavy"],
    "two_pattern_group": PREFIX + f"""SELECT * WHERE {{
        ?X ub:worksFor {DEPT0} .
        OPTIONAL {{ ?X ub:teacherOf ?C . ?C ub:name ?N }} }}""",
    "two_groups": PREFIX + f"""SELECT * WHERE {{
        ?S ub:memberOf {DEPT0} . OPTIONAL {{ ?S ub:advisor ?A }}
        OPTIONAL {{ ?S ub:emailAddress ?E }} }}""",
    "nested": PREFIX + f"""SELECT * WHERE {{
        ?S ub:memberOf {DEPT0} .
        OPTIONAL {{ ?S ub:advisor ?A . OPTIONAL {{ ?A ub:teacherOf ?C }} }}
        }}""",
    "only_optional": PREFIX + """SELECT * WHERE {
        OPTIONAL { ?X ub:subOrganizationOf <http://www.University0.edu> }
        }""",
}

UNION = {
    "branches": EXT["x_union"],
    "index_branches": EXT["x_union_index"],
    "top_level": PREFIX + """SELECT ?X WHERE {
        { ?X rdf:type ub:FullProfessor . ?X ub:worksFor
          <http://www.Department0.University0.edu> }
        UNION { ?X rdf:type ub:Lecturer } }""",
}

ATTR = {
    "age_filter": EXT["x_attr"],
    "age": PREFIX + f"""SELECT ?X ?A WHERE {{
        ?X ub:memberOf {DEPT0} . ?X ub:age ?A }}""",
    "id": PREFIX + f"""SELECT ?X ?I WHERE {{
        ?X ub:worksFor {DEPT0} . ?X rdf:type ub:FullProfessor .
        ?X ub:id ?I }}""",
}


@pytest.mark.parametrize("name", sorted(OPTIONAL))
def test_dist_optional_suite(world, name):
    assert check_text(world, OPTIONAL[name]).result.status_code == 0


@pytest.mark.parametrize("name", sorted(UNION))
def test_dist_union_suite(world, name):
    pq = check_text(world, UNION[name])
    assert pq.result.status_code == 0 and pq.result.nrows > 0


def test_dist_union_branch_filters(world):
    pq = check_text(world, PREFIX + """SELECT ?X ?Y WHERE {
        { ?X rdf:type ub:Course . ?X ub:name ?Y .
          FILTER regex(?Y, "Course1.*") }
        UNION { ?X rdf:type ub:GraduateCourse . ?X ub:name ?Y . } }""")
    assert pq.result.nrows > 0


def test_dist_union_seeded_by_patterns(world):
    pq = check_text(world, PREFIX + """SELECT ?X ?Y ?Z WHERE {
        ?X ub:memberOf ?Y .
        { ?X ub:undergraduateDegreeFrom ?Z . }
        UNION { ?X ub:mastersDegreeFrom ?Z . } }""")
    assert pq.result.nrows > 0


def test_dist_optional_with_blanks_then_filter(world):
    check_text(world, PREFIX + """SELECT ?S ?UG ?DOC WHERE {
        ?S ub:undergraduateDegreeFrom ?UG .
        OPTIONAL { ?S ub:doctoralDegreeFrom ?DOC } .
        FILTER (!bound(?DOC)) }""")


def test_dist_optional_filter_on_parent_var(world):
    check_text(world, PREFIX + """SELECT ?S ?UG ?DOC WHERE {
        ?S ub:undergraduateDegreeFrom ?UG .
        OPTIONAL { ?S ub:doctoralDegreeFrom ?DOC . FILTER(?UG != ?DOC) } .
        }""")


def test_dist_blind_optional_union_silent_parity(world):
    """Silent mode for any shape: blind OPTIONAL and UNION replies carry
    the true count and no table."""
    for text in (OPTIONAL["heavy"], UNION["branches"]):
        jq, pq = run_text(world, text, blind=True)
        same(jq, pq)
        _jf, full = run_text(world, text)
        assert pq.result.nrows == full.result.nrows > 0
        assert pq.result.table.size == 0


@pytest.fixture(scope="module")
def attr_world(eight_cpu_devices):
    return World(1, 42, attrs=True)


@pytest.mark.parametrize("name", sorted(ATTR))
def test_dist_attr_suite(attr_world, name, monkeypatch):
    monkeypatch.setattr(JG, "enable_vattr", True)
    pq = check_text(attr_world, ATTR[name])
    assert pq.result.status_code == 0 and pq.result.nrows > 0


def test_dist_versatile_kuu(world):
    check_text(world, EXT["x_vers_kuu"])
    # a continuation anchored on the versatile value column
    pq = check_text(world, PREFIX + f"""SELECT ?X ?P ?Y WHERE {{
        ?X ub:worksFor {DEPT0} . ?X ?P ?Y . ?Y rdf:type ub:Course . }}""")
    assert pq.result.nrows > 0
    for name in ("x_vers_const", "x_vers_const2", "x_vers_kuc",
                 "x_vers_kuc_fold"):
        assert check_text(world, EXT[name]).result.nrows > 0, name
