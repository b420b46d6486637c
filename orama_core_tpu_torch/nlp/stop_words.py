"""Stop-word tables.

The reference codegens tables from 33 ``.txt`` lists at build time
(`build.rs:6-76`). Here the major-language lists are inlined (standard
public-domain Snowball-project lists); locales without a table fall back to
an empty set, which only affects ranking, not correctness.

Port of ``orama_core_tpu/nlp/stop_words.py``: host code, copied with its imports
re-pointed at ``orama_core_tpu_torch``.
"""

from __future__ import annotations

from typing import Dict, FrozenSet

_TABLES: Dict[str, FrozenSet[str]] = {}


def _t(locale: str, words: str) -> None:
    _TABLES[locale] = frozenset(words.split())


_t("en", """
a about above after again against all am an and any are aren arent as at be
because been before being below between both but by cant cannot could couldnt
did didn didnt do does doesn doesnt doing don dont down during each few for
from further had hadn hadnt has hasn hasnt have haven havent having he her
here hers herself him himself his how i if in into is isn isnt it its itself
just me more most mustn mustnt my myself no nor not now of off on once only
or other ought our ours ourselves out over own same shan shant she should
shouldn shouldnt so some such than that the their theirs them themselves then
there these they this those through to too under until up very was wasn wasnt
we were weren werent what when where which while who whom why will with won
wont would wouldn wouldnt you your yours yourself yourselves
""")

_t("es", """
de la que el en y a los del se las por un para con no una su al lo como mas
pero sus le ya o este si porque esta entre cuando muy sin sobre tambien me
hasta hay donde quien desde todo nos durante todos uno les ni contra otros
ese eso ante ellos e esto mi antes algunos que unos yo otro otras otra el
tanto esa estos mucho quienes nada muchos cual poco ella estar estas algunas
algo nosotros
""")

_t("fr", """
au aux avec ce ces dans de des du elle en et eux il ils je la le les leur lui
ma mais me meme mes moi mon ne nos notre nous on ou par pas pour qu que qui sa
se ses son sur ta te tes toi ton tu un une vos votre vous c d j l m n s t y
ete etee etees etes etant suis es est sommes etes sont serai seras sera serons
serez seront serais serait serions seriez seraient etais etait etions etiez
etaient fus fut fumes futes furent sois soit soyons soyez soient fusse fusses
fussions fussiez fussent ayant eu eue eues eus ai as avons avez ont aurai
auras aura aurons aurez auront aurais aurait aurions auriez auraient avais
avait avions aviez avaient eut eumes eutes eurent aie aies ait ayons ayez
aient eusse eusses eussions eussiez eussent
""")

_t("de", """
aber alle allem allen aller alles als also am an ander andere anderem anderen
anderer anderes anderm andern anderr anders auch auf aus bei bin bis bist da
damit dann der den des dem die das dass derselbe derselben demselben dieselbe
dieselben dasselbe dazu dein deine deinem deinen deiner deines denn derer
dessen dich dir du dies diese diesem diesen dieser dieses doch dort durch ein
eine einem einen einer eines einig einige einigem einigen einiger einiges
einmal er ihn ihm es etwas euer eure eurem euren eurer eures fur gegen gewesen
hab habe haben hat hatte hatten hier hin hinter ich mich mir ihr ihre ihrem
ihren ihrer ihres euch im in indem ins ist jede jedem jeden jeder jedes jene
jenem jenen jener jenes jetzt kann kein keine keinem keinen keiner keines
konnen konnte machen man manche manchem manchen mancher manches mein meine
meinem meinen meiner meines mit muss musste nach nicht nichts noch nun nur ob
oder ohne sehr sein seine seinem seinen seiner seines selbst sich sie ihnen
sind so solche solchem solchen solcher solches soll sollte sondern sonst uber
um und uns unsere unserem unseren unser unseres unter viel vom von vor wahrend
war waren warst was weg weil weiter welche welchem welchen welcher welches
wenn werde werden wie wieder will wir wird wirst wo wollen wollte wurde wurden
zu zum zur zwar zwischen
""")

_t("it", """
ad al allo ai agli all agl alla alle con col coi da dal dallo dai dagli dall
dagl dalla dalle di del dello dei degli dell degl della delle in nel nello nei
negli nell negl nella nelle su sul sullo sui sugli sull sugl sulla sulle per
tra contro io tu lui lei noi voi loro mio mia miei mie tuo tua tuoi tue suo
sua suoi sue nostro nostra nostri nostre vostro vostra vostri vostre mi ti ci
vi lo la li le gli ne il un uno una ma ed se perche anche come dov dove che
chi cui non piu quale quanto quanti quanta quante quello quelli quella quelle
questo questi questa queste si tutto tutti a c e o ho hai ha abbiamo avete
hanno abbia abbiate abbiano avro avrai avra avremo avrete avranno avrei
avresti avrebbe avremmo avreste avrebbero avevo avevi aveva avevamo avevate
avevano ebbi avesti ebbe avemmo aveste ebbero avessi avesse avessimo avessero
avendo avuto avuta avuti avute sono sei e siamo siete sia siate siano saro
sarai sara saremo sarete saranno sarei saresti sarebbe saremmo sareste
sarebbero ero eri era eravamo eravate erano fui fosti fu fummo foste furono
fossi fosse fossimo fossero essendo faccio fai facciamo fanno faccia facciate
facciano faro farai fara faremo farete faranno farei faresti farebbe faremmo
fareste farebbero facevo facevi faceva facevamo facevate facevano feci facesti
fece facemmo faceste fecero facessi facesse facessimo facessero facendo sto
stai sta stiamo stanno stia stiate stiano staro starai stara staremo starete
staranno starei staresti starebbe staremmo stareste starebbero stavo stavi
stava stavamo stavate stavano stetti stesti stette stemmo steste stettero
stessi stesse stessimo stessero stando
""")

_t("pt", """
de a o que e do da em um para e com nao uma os no se na por mais as dos como
mas foi ao ele das tem a seu sua ou ser quando muito ha nos ja esta eu tambem
so pelo pela ate isso ela entre era depois sem mesmo aos ter seus quem nas me
esse eles estao voce tinha foram essa num nem suas meu as minha tem numa
pelos elas havia seja qual sera nos tenho lhe deles essas esses pelas este
fosse dele tu te voces vos lhes meus minhas teu tua teus tuas nosso nossa
nossos nossas dela delas esta estes estas aquele aquela aqueles aquelas isto
aquilo estou esta estamos estao estive esteve estivemos estiveram estava
estavamos estavam estivera estiveramos esteja estejamos estejam estivesse
estivessemos estivessem estiver estivermos estiverem hei ha havemos hao houve
houvemos houveram houvera houveramos haja hajamos hajam houvesse houvessemos
houvessem houver houvermos houverem houverei houvera houveremos houverao
houveria houveriamos houveriam sou somos sao era eramos eram fui foi fomos
foram fora foramos seja sejamos sejam fosse fossemos fossem for formos forem
serei sera seremos serao seria seriamos seriam tenho tem temos tem tinha
tinhamos tinham tive teve tivemos tiveram tivera tiveramos tenha tenhamos
tenham tivesse tivessemos tivessem tiver tivermos tiverem terei tera teremos
terao teria teriamos teriam
""")

_t("nl", """
de en van ik te dat die in een hij het niet zijn is was op aan met als voor
had er maar om hem dan zou of wat mijn men dit zo door over ze zich bij ook
tot je mij uit der daar haar naar heb hoe heeft hebben deze u want nog zal me
zij nu ge geen omdat iets worden toch al waren veel meer doen toen moet ben
zonder kan hun dus alles onder ja eens hier wie werd altijd doch wordt
wezen kunnen ons zelf tegen na reeds wil kon niets uw iemand geweest andere
""")

_t("ru", """
и в во не что он на я с со как а то все она так его но да ты к у же вы за бы
по только ее мне было вот от меня еще нет о из ему теперь когда даже ну вдруг
ли если уже или ни быть был него до вас нибудь опять уж вам ведь там потом
себя ничего ей может они тут где есть надо ней для мы тебя их чем была сам
чтоб без будто чего раз тоже себе под будет ж тогда кто этот того потому
этого какой совсем ним здесь этом один почти мой тем чтобы нее сейчас были
куда зачем всех никогда можно при наконец два об другой хоть после над больше
тот через эти нас про всего них какая много разве три эту моя впрочем хорошо
свою этой перед иногда лучше чуть том нельзя такой им более всегда конечно
всю между
""")

_t("sv", """
och det att i en jag hon som han pa den med var sig for sa till ar men ett om
hade de av icke mig du henne da sin nu har inte hans honom skulle hennes dar
min man ej vid kunde nagot fran ut nar efter upp vi dem vara vad over an dig
kan sina har ha mot alla under nagon eller allt mycket sedan ju denna sjalv
detta at utan varit hur ingen mitt ni bli blev oss din dessa nagra deras blir
mina samma vilken er sadan vart dina vars vem vilka ocksa
""")

# remaining reference locales (24 tables) live in the generated data module
from .stop_words_extra import TABLES as _EXTRA  # noqa: E402

for _loc, _words in _EXTRA.items():
    _TABLES.setdefault(_loc, _words)

EMPTY: FrozenSet[str] = frozenset()


def stop_words(locale: str) -> FrozenSet[str]:
    return _TABLES.get(locale, EMPTY)
