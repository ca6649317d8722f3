"""Tests for anno_classes.json parsing — validation parity with
annonet_parse_anno_classes.cpp:21-83."""

import json

import pytest

from annonet_jax.classes import (
    AnnoClass,
    RGBA_IGNORE,
    anno_classes_to_json,
    default_anno_classes,
    parse_anno_classes,
)


def test_empty_json_gives_default_classes():
    classes = parse_anno_classes("")
    assert [c.classlabel for c in classes] == ["clean", "minor defect", "major defect"]
    assert classes[0].rgba_label == (0, 255, 0, 64)
    assert classes[1].rgba_label == (255, 255, 0, 128)
    assert classes[2].rgba_label == (255, 0, 0, 128)
    assert [c.index for c in classes] == [0, 1, 2]


def test_parse_valid_json_indices_follow_array_position():
    doc = {
        "anno_classes": [
            {"name": "bg", "color": {"red": 1, "green": 2, "blue": 3, "alpha": 4}},
            {"name": "fg", "color": {"red": 5, "green": 6, "blue": 7, "alpha": 8}},
        ]
    }
    classes = parse_anno_classes(json.dumps(doc))
    assert len(classes) == 2
    assert classes[0] == AnnoClass(0, (1, 2, 3, 4), "bg")
    assert classes[1] == AnnoClass(1, (5, 6, 7, 8), "fg")


def test_parse_error_message():
    with pytest.raises(RuntimeError, match="Error parsing json"):
        parse_anno_classes("{not valid")


def test_document_must_be_object():
    with pytest.raises(RuntimeError, match="should be an object"):
        parse_anno_classes("[1, 2, 3]")


def test_requires_anno_classes_array():
    with pytest.raises(RuntimeError, match="anno_classes array"):
        parse_anno_classes('{"foo": 1}')
    with pytest.raises(RuntimeError, match="anno_classes array"):
        parse_anno_classes('{"anno_classes": 17}')


def test_requires_name_and_color():
    with pytest.raises(RuntimeError, match="no name found"):
        parse_anno_classes('{"anno_classes": [{"color": {}}]}')
    with pytest.raises(RuntimeError, match="no color found"):
        parse_anno_classes('{"anno_classes": [{"name": "x"}]}')
    with pytest.raises(RuntimeError, match="all components"):
        parse_anno_classes(
            '{"anno_classes": [{"name": "x", "color": {"red": 1, "green": 2, "blue": 3}}]}'
        )


def test_reserved_ignore_color_rejected():
    doc = {
        "anno_classes": [
            {"name": "x", "color": {"red": 0, "green": 0, "blue": 0, "alpha": 0}}
        ]
    }
    with pytest.raises(RuntimeError, match="reserved for pixels to be ignored"):
        parse_anno_classes(json.dumps(doc))
    assert RGBA_IGNORE == (0, 0, 0, 0)


def test_json_round_trip():
    classes = default_anno_classes()
    text = anno_classes_to_json(classes)
    assert parse_anno_classes(text) == classes
